"""One module a kind of cell: `run(cell) -> harness.Measured`."""
