"""The parts of the benchmark that every cell shares."""
