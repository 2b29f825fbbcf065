"""Packed anchor-table payload: searched reads as pure numpy arrays.

The multi-host data plane ships each searched window from its owning
worker to the coordinator.  Instead of pickled Python objects, the wire
format is a flat dict of numpy arrays — the SoA shape that becomes a
padded DCN all-gather / broadcast on a real pod (SURVEY §2.3/§7: merge
per-shard candidate anchors with collectives before host clustering):

* per-read scalar columns (anchor position, insert size, mismatch
  counts, flags) as int64/bool arrays;
* string columns (read name, sequence, sample tag, chromosome names)
  as one UTF-8 byte buffer + offset array each;
* the close/far anchor chains as ragged SoA tables — ``cl_off``/``fa_off``
  offset arrays into flat ``len``/``loc``/``mm``/``dm``/``sm``/``cid``
  columns, exactly the RaggedAnchors layout the detectors consume.

``pack`` flattens a list of searched SplitReads; ``unpack`` rebuilds
them (AnchorSets are zero-copy slices of the shared columns).  The dict
round-trips through ``np.savez`` with ``allow_pickle=False`` — there is
deliberately no code path that unpickles objects from the spool.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from pindel_tpu_torch.reads import AnchorSet, SplitRead

_STR_COLS = ("name", "frag_name", "far_frag_name", "matched_d",
             "matched_far_d", "tag", "seq")
_INT_COLS = ("matched_rel_pos", "ms", "insert_size", "max_snp_error",
             "close_end_mismatch", "far_end_mismatch", "left_most_pos")
_BOOL_COLS = ("mapper_split", "unique_read")


def _pack_strings(values: List[str]):
    """List[str] -> (uint8 buffer, int64 offsets[n+1])."""
    blobs = [v.encode() for v in values]
    off = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=off[1:])
    buf = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return buf, off


def _unpack_strings(buf: np.ndarray, off: np.ndarray) -> List[str]:
    raw = buf.tobytes()
    return [raw[off[i]:off[i + 1]].decode() for i in range(off.size - 1)]


def _pack_anchors(chains: List[AnchorSet], prefix: str,
                  out: Dict[str, np.ndarray]) -> None:
    n = len(chains)
    counts = np.fromiter((len(c) for c in chains), np.int64, n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    t = int(off[n])
    length = np.empty(t, np.int64)
    loc = np.empty(t, np.int64)
    mm = np.empty(t, np.int64)
    dm = np.empty(t, bool)
    sm = np.empty(t, bool)
    cid = np.empty(t, np.int8)
    uniform = np.empty(n, bool)
    names: List[str] = []
    name_idx: Dict[str, int] = {}
    cid_map = np.empty(0, np.int8)
    for k, c in enumerate(chains):
        a, b = off[k], off[k + 1]
        length[a:b] = c.length
        loc[a:b] = c.loc
        mm[a:b] = c.mm
        dm[a:b] = c.dir_minus
        sm[a:b] = c.strand_minus
        uniform[k] = c.uniform
        if b > a:
            # remap the chain's local chr ids into the shared name table
            if len(c.chr_names) > cid_map.shape[0]:
                cid_map = np.empty(len(c.chr_names), np.int8)
            for j, nm in enumerate(c.chr_names):
                gi = name_idx.get(nm)
                if gi is None:
                    gi = name_idx[nm] = len(names)
                    names.append(nm)
                cid_map[j] = gi
            cid[a:b] = cid_map[:len(c.chr_names)][c.chr_id] \
                if len(c.chr_names) else c.chr_id
    nb, no = _pack_strings(names)
    out[prefix + "_off"] = off
    out[prefix + "_len"] = length
    out[prefix + "_loc"] = loc
    out[prefix + "_mm"] = mm
    out[prefix + "_dm"] = dm
    out[prefix + "_sm"] = sm
    out[prefix + "_cid"] = cid
    out[prefix + "_uniform"] = uniform
    out[prefix + "_chr_buf"] = nb
    out[prefix + "_chr_off"] = no


def _unpack_anchors(d: Dict[str, np.ndarray], prefix: str, n: int
                    ) -> List[AnchorSet]:
    off = d[prefix + "_off"]
    length = d[prefix + "_len"]
    loc = d[prefix + "_loc"]
    mm = d[prefix + "_mm"]
    dm = d[prefix + "_dm"]
    sm = d[prefix + "_sm"]
    cid = d[prefix + "_cid"]
    uniform = d[prefix + "_uniform"]
    names = _unpack_strings(d[prefix + "_chr_buf"], d[prefix + "_chr_off"])
    out: List[AnchorSet] = []
    empty = AnchorSet.empty()
    for k in range(n):
        a, b = off[k], off[k + 1]
        if a == b:
            out.append(empty)
            continue
        c = AnchorSet(length[a:b], loc[a:b], mm[a:b], dm[a:b], sm[a:b],
                      names, cid[a:b])
        c.uniform = bool(uniform[k])
        out.append(c)
    return out


def pack(kept: List[SplitRead], bd_delta=None,
         rp_text: str = "") -> Dict[str, np.ndarray]:
    """Searched reads (plus the window's RP->BD evidence delta and _RP
    report text, when BAM discovery is on) -> flat dict of pure numpy
    arrays."""
    out: Dict[str, np.ndarray] = {"n": np.array([len(kept)], np.int64)}
    for col in _STR_COLS:
        buf, off = _pack_strings([getattr(r, col) for r in kept])
        out["s_" + col] = buf
        out["o_" + col] = off
    for col in _INT_COLS:
        out["i_" + col] = np.fromiter(
            (getattr(r, col) for r in kept), np.int64, len(kept))
    for col in _BOOL_COLS:
        out["b_" + col] = np.fromiter(
            (getattr(r, col) for r in kept), bool, len(kept))
    _pack_anchors([r.up_close for r in kept], "cl", out)
    _pack_anchors([r.up_far for r in kept], "fa", out)
    # window evidence delta: [n, 6] (a_cid, a_pos, a_pos2, b_cid, ...)
    evs = bd_delta or []
    names: List[str] = []
    name_idx: Dict[str, int] = {}
    tab = np.zeros((len(evs), 6), np.int64)
    for k, (a, b) in enumerate(evs):
        for j, c in enumerate((a, b)):
            gi = name_idx.get(c.chr_name)
            if gi is None:
                gi = name_idx[c.chr_name] = len(names)
                names.append(c.chr_name)
            tab[k, 3 * j] = gi
            tab[k, 3 * j + 1] = c.pos
            tab[k, 3 * j + 2] = c.pos2
    nb, no = _pack_strings(names)
    out["bdv_tab"] = tab.reshape(-1)
    out["bdv_chr_buf"] = nb
    out["bdv_chr_off"] = no
    out["bdv_rp_text"] = np.frombuffer(rp_text.encode(), np.uint8)
    return out


def unpack_bd(d: Dict[str, np.ndarray]):
    """(bd event delta, _RP text) from a packed window dict."""
    from pindel_tpu_torch.bddata import BDCoord
    names = _unpack_strings(d["bdv_chr_buf"], d["bdv_chr_off"])
    tab = d["bdv_tab"].reshape(-1, 6)
    delta = [(BDCoord(names[int(r[0])], int(r[1]), int(r[2])),
              BDCoord(names[int(r[3])], int(r[4]), int(r[5])))
             for r in tab]
    return delta, d["bdv_rp_text"].tobytes().decode()


def unpack(d: Dict[str, np.ndarray]) -> List[SplitRead]:
    """Inverse of ``pack`` (AnchorSets are views of the shared columns)."""
    n = int(d["n"][0])
    strs = {col: _unpack_strings(d["s_" + col], d["o_" + col])
            for col in _STR_COLS}
    ints = {col: d["i_" + col] for col in _INT_COLS}
    bools = {col: d["b_" + col] for col in _BOOL_COLS}
    close = _unpack_anchors(d, "cl", n)
    far = _unpack_anchors(d, "fa", n)
    proto = SplitRead().__dict__
    out: List[SplitRead] = []
    new = SplitRead.__new__
    for k in range(n):
        dd = dict(proto)
        for col in _STR_COLS:
            dd[col] = strs[col][k]
        for col in _INT_COLS:
            dd[col] = int(ints[col][k])
        for col in _BOOL_COLS:
            dd[col] = bool(bools[col][k])
        dd["up_close"] = close[k]
        dd["up_far"] = far[k]
        dd["used"] = False
        dd["sample_name_to_number"] = {dd["tag"]: 1}
        r = new(SplitRead)
        r.__dict__ = dd
        out.append(r)
    return out
