"""Replay stores of the port (DDiffPG's episodic store)."""
