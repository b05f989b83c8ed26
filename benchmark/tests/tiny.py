"""Tiny sizes of the cells for the CPU tests: every width as published,
far fewer envs, samples and steps."""

TRAIN = {"config": {"config": {"algo": {"batch_size": 48, "memory_size": 16,
                                        "warm_up": 0, "update_times": 2},
                               "diffusion": {"update_times": 2}}},
         "traffic": {"num_envs": 8, "synthetic": {"successes": 8},
                     "probe_passes": 1, "profiled_units": 1,
                     "followed_iters": 2}}
COLLECT = {"traffic": {"num_envs": 8, "steps_per_call": 4, "probe_calls": 2,
                       "checked_calls": 2}}
PANDA = {"traffic": {"num_envs": 4, "steps_per_call": 2, "probe_calls": 1,
                     "checked_calls": 1, "warmup_calls": 0}}
SIZES = {"ddiffpg-antmaze-v1.train": TRAIN,
         "ddiffpg-antmaze-v1.collect": COLLECT,
         "ddiffpg-drawermulti-joints.collect": PANDA}


def run(name, seed=12345678901, trace=False, candidates=(), over=None):
    from benchmark.harness import cell
    sizes = cell.merge(SIZES[name], over or {})
    return cell.run(name, seed, 0.01, trace, "cpu", overrides=sizes,
                    candidates=candidates)
