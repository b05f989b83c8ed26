"""Env steps acted a second on the host's clock, in the traced run's
window (no profiler in it): num_envs x steps_per_call for each `collect`
call completed, over the window's seconds, a synchronize at its end. The
rate a user of the collect path sees in a cell whose device waits on the
host; it follows the host's speed, which moves by tens of percent from
run to run on a shared host."""


def read(rec):
    win = rec["window"]
    if not win.get("env_steps") or not win.get("seconds"):
        return None
    return win["env_steps"] / win["seconds"]
