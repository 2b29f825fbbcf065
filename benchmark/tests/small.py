"""The benchmark's cells cut to a size the CPU tests can hold: 300 kb in
three 100 kb windows at the cells' densities."""
import harness

SPEC = harness.load_spec()


def small_cell(name: str) -> harness.Cell:
    cell = harness.cell_of(SPEC, name)
    g = cell.config["generator"]
    g["chrom_len"] = 300_000
    if g["kind"] == "text":
        g["events_per_kind"] = 3
        g["n_noise"] = 1_600
    cell.config["flags"] = list(cell.config["flags"]) + ["-w", "0.1"]
    return cell
