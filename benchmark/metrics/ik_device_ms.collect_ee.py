"""Device ms a control step of the Panda `ee` control's IK (the span `ik`,
`PandaTaskEnv._ctrl_from_action`'s `ee` branch: the FK, the target and
`Arm.dls_ik`), by correlation id, in the span window
(`benchmark/harness/spans.py`), over the control steps (spans
`collect_step`) in it."""

from benchmark.harness.spans import per


def read(rec):
    return per(rec, "ik", "device_s", "collect_step", scale=1e3)
