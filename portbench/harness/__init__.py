"""What every cell shares: finding its files, seeds, inputs, the chip,
the trace, and the run that ties them together (``cell.run_cell``)."""
