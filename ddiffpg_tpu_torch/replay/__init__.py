"""Replay stores of the port: DDiffPG's episodic store and the baselines'
flat transition ring."""
