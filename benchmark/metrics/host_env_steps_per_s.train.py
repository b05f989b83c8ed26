"""Env steps trained a second on the host's clock, in the traced run's
window (no profiler in it): num_envs x horizon_len for each `train_iter`
completed, over the window's seconds, a synchronize at its end. The rate
a user of the train loop sees; it follows the host's speed, which moves
by tens of percent from run to run on a shared host."""


def read(rec):
    win = rec["window"]
    if not win.get("env_steps") or not win.get("seconds"):
        return None
    return win["env_steps"] / win["seconds"]
