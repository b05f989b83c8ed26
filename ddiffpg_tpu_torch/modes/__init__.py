"""Mode discovery: DTW trajectory clustering + per-mode critic lifecycle."""
