"""Device ms a control step of the Panda end-effector state (the span
`ee_state`, `PandaTaskEnv._ee_state`: forward kinematics and the body
velocities), by correlation id, in the span window
(`benchmark/harness/spans.py`), over the control steps (spans
`collect_step`) in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "ee_state", "device_s", "collect_step", scale=1e3)
