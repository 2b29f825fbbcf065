"""TCPStore window transport: point-to-point anchor-table sends (port of
pindel_tpu/parallel/distspool.py).

The transport behind ``--hosts N --dist store``: the coordinator serves a
``torch.distributed.TCPStore`` on 127.0.0.1 before it spawns its workers
(``serve``), and each worker connects to it as a client (``connect``).  A
worker-owned window's packed anchor tables (parallel/payload.py) move to
the coordinator as two keys: one concatenated uint8 blob, then a fixed
int64 length header, so a window whose header is in the store is whole.
Only the producing worker and the consuming coordinator touch a window's
payload.  The coordinator deletes each window's keys after loading them,
so the store holds only the windows that workers have run ahead by.

The blob layout follows ``payload.pack``'s key order (deterministic dict
order): the receiver rebuilds dtypes and shapes from the header alone, so
ragged windows need no shapes agreed beforehand.
"""
from __future__ import annotations

import datetime
from typing import Dict, List

import numpy as np
import torch.distributed as dist

from pindel_tpu_torch.parallel import payload
from pindel_tpu_torch.parallel.multihost import Spool

TIMEOUT = datetime.timedelta(seconds=Spool.TIMEOUT)

# fixed schema: (key, dtype) in wire order.  Arrays are 1-D.
_SCHEMA = None


def _schema():
    global _SCHEMA
    if _SCHEMA is None:
        probe = payload.pack([])
        _SCHEMA = [(k, v.dtype) for k, v in probe.items()]
    return _SCHEMA


def _encode(arrs: Dict[str, np.ndarray]):
    schema = _schema()
    assert list(arrs.keys()) == [k for k, _ in schema], "schema drift"
    parts = [np.ascontiguousarray(arrs[k]).view(np.uint8).reshape(-1)
             for k, _ in schema]
    header = np.array([p.size for p in parts], np.int64)
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return header, blob


def _decode(header: np.ndarray, blob: np.ndarray) -> Dict[str, np.ndarray]:
    schema = _schema()
    out: Dict[str, np.ndarray] = {}
    off = 0
    for (k, dt), nbytes in zip(schema, header.tolist()):
        raw = blob[off:off + int(nbytes)]
        out[k] = np.frombuffer(raw.tobytes(), dtype=dt)
        off += int(nbytes)
    return out


def serve() -> dist.TCPStore:
    """The coordinator's store on 127.0.0.1, on a free port (``.port``).
    It does not wait for clients: they are spawned after it exists."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False, timeout=TIMEOUT)


def connect(port: int) -> dist.TCPStore:
    """A worker's client of the coordinator's store."""
    return dist.TCPStore("127.0.0.1", port, is_master=False,
                         timeout=TIMEOUT)


class StoreSpool(Spool):
    """Window spool over a TCPStore: the interface Pipeline consumes
    (``mine``/``worker``/``dump``/``load``)."""

    def __init__(self, store: dist.TCPStore, rank: int, num_hosts: int,
                 procs=None):
        super().__init__(rank, num_hosts, procs)
        self.store = store

    @staticmethod
    def keys(widx: int) -> List[str]:
        """A window's keys: header, blob."""
        return [f"pindel/w{widx}/h", f"pindel/w{widx}/b"]

    def dump(self, widx: int, kept: List, bd_delta=None,
             rp_text: str = "") -> None:
        """Owner side: send this window's searched reads (plus its RP->BD
        evidence delta and _RP text) to the coordinator."""
        header, blob = _encode(payload.pack(kept, bd_delta, rp_text))
        h_key, b_key = self.keys(widx)
        self.store.set(b_key, blob.tobytes())
        self.store.set(h_key, header.tobytes())
        self._shipped()

    def load(self, widx: int):
        """Coordinator side for a worker-owned window: wait for it, watching
        the workers, -> (reads, bd delta, _RP text); its keys are deleted
        afterwards."""
        h_key, b_key = self.keys(widx)
        self._wait(widx, lambda: self.store.check([h_key]))
        header = np.frombuffer(self.store.get(h_key), np.int64)
        blob = np.frombuffer(self.store.get(b_key), np.uint8)
        for key in (h_key, b_key):
            self.store.delete_key(key)
        d = _decode(header, blob)
        return payload.unpack(d), *payload.unpack_bd(d)
