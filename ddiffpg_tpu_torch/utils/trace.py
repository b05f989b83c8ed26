"""Layer spans of the port, on the clock of the device trace.

`span(name)` marks one layer's work. With the spans enabled it is a
`torch.profiler.record_function("ddiffpg/" + name)` range: a running
`torch.profiler` session records it on the same Kineto timeline as the
device's activities, so a span has a start, an end and a parent (the span
it nests in) on the device trace's clock, and every kernel launched inside
it leads back to it through its runtime launch's correlation id. Off (the
default), `span` checks one flag and returns a shared no-op context: no
profiler call, no allocation, no device call. There is no exporter here:
the profiler session that runs keeps the spans and writes them out
(`cfg.profile` in `train.py`, the benchmark's span window).

The spans, parent first: `train_step` (`AgentDDiffPG.train_iter`) >
`env_step` (`_env_step`) > `actor` (`explore_actions`), `env`
(`VecEnv.step`) > `physics` (`envs/base.py:step_physics`) and, on Panda,
`ee_state` (`PandaTaskEnv._ee_state`), then `replay_add`
(`replay/episodic.py:add`); `train_step` > `update_pass` (`update_once`) >
its seven parts (`sample`, `NovelD reward`, `target actions`,
`critic update`, `action gradient`, `actor loss and step`, `RND update`);
`collect_step` (one step of `agents/ddiffpg.py:collect`) > `actor`, `env`.
The baselines' update passes carry their parts through `part`.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "ddiffpg/"
_on = False
_OFF = contextlib.nullcontext()


def enable(flag: bool) -> None:
    """Turn the spans on or off for the whole process."""
    global _on
    _on = bool(flag)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context over one layer's work (see the module's docstring)."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def part(name: str, mark=None):
    """The span of one part of an update pass; `mark`, when given (a
    timing hook), is called with `name` as the part's span ends."""
    if mark is None:
        return span(name)
    return _marked(name, mark)


@contextlib.contextmanager
def _marked(name: str, mark):
    with span(name):
        yield
    mark(name)
