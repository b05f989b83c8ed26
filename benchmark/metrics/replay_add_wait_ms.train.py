"""Host ms an env step spends in blocking runtime calls inside the
episodic replay's `add` (the span `replay_add`: its `torch.nonzero` over
the finished envs waits for the device), in the span window
(`benchmark/harness/spans.py`), over the env steps (spans `env_step`) in
it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "replay_add", "sync_s", "env_step", scale=1e3)
