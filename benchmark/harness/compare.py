"""The numbers that decide `correct`, each against its limit.

Every number is a gap between a candidate (the program, or in the
calibration the control or a planted fault) and the reference; a run is
correct when every gap is finite and at most its limit. The limits live in
the cell's traffic file under `limits`, with the readings they were set
from in PERF.md.

Training (`train_gaps`):
  loss_gap    the largest relative gap of a followed iteration's critic,
              actor or RND loss (|c - r| / |r|)
  moment_gap  the worst leaf's gap of the Adam first moment's norm after
              the first iteration, |‖m_c‖ - ‖m_r‖| over the larger of the
              reference leaf's norm and the median leaf's
  change_gap  the worst leaf's gap, so measured, of the norm of its change
              over the followed iterations
  group_gap   the faults of the candidate's replay groups against those
              the reference works out from the raw trajectories
              (`benchmark/reference/groups.py`); exact
Leaves whose reference moment is under a thousandth of the median leaf's
(the RND target net, which only weight decay moves) are left out of both
leaf gaps; a target critic leaf is judged by its critic leaf's moment.

Collect (`collect_gaps`):
  action_gap     the largest |a_c - a_r| over every step and env of the
                 sampled calls
  obs_gap        the largest |o_c - o_r| / (1 + |o_r|) of the next obs of
                 the first env step and of the reset envs' second step
  flag_mismatch  the envs whose reward, done or success differ there
"""

from __future__ import annotations

import math
import statistics

import torch

from benchmark.reference.follow import LOSSES


def _gap_row(name: str, value: float, limits: dict) -> dict:
    return {"name": name, "value": float(value),
            "limit": float(limits[name])}


def _leaf_gap(cand: dict, ref: dict, keep) -> float:
    med = statistics.median(ref[k] for k in ref if keep(k))
    worst = 0.0
    for k, r in ref.items():
        if not keep(k):
            continue
        c = cand.get(k, math.nan)
        worst = max(worst, abs(c - r) / max(r, med), 0.0) \
            if math.isfinite(c) else math.inf
    return worst


def train_gaps(cand: dict, ref: dict, limits: dict) -> list:
    loss = 0.0
    for lc, lr in zip(cand["logs"], ref["logs"]):
        for k in LOSSES:
            c, r = lc[k], lr[k]
            loss = max(loss, abs(c - r) / max(abs(r), 1e-30)) \
                if math.isfinite(c) else math.inf
    m = ref["moments"]
    med = statistics.median(m.values())

    def moved(k):
        return m[k.replace("critic_target.", "critic.")] >= 1e-3 * med

    return [_gap_row("loss_gap", loss, limits),
            _gap_row("moment_gap", _leaf_gap(cand["moments"], m, moved),
                     limits),
            _gap_row("change_gap", _leaf_gap(cand["change"], ref["change"],
                                             moved), limits),
            _gap_row("group_gap", cand["group_gap"], limits)]


def collect_gaps(cand: list, ref: list, limits: dict) -> list:
    act = obs = 0.0
    flags = 0

    def obs_rel(c, r):
        d = (c.float() - r.float()).abs() / (1.0 + r.float().abs())
        return float(torch.nan_to_num(d, nan=math.inf).max())

    def mismatch(c, r):
        return int(((c[1] != r[1]) | (c[2] != r[2]) | (c[3] != r[3])).sum())

    for c, r in zip(cand, ref):
        d = (c["actions"].float() - r["actions"].float()).abs()
        act = max(act, float(torch.nan_to_num(d, nan=math.inf).max()))
        obs = max(obs, obs_rel(c["step0"][0], r["step0"][0]))
        flags += mismatch(c["step0"], r["step0"])
        if r["step1"] is not None:
            obs = max(obs, obs_rel(c["step1"][1], r["step1"][1]))
            flags += mismatch(c["step1"][1:], r["step1"][1:])
    return [_gap_row("action_gap", act, limits),
            _gap_row("obs_gap", obs, limits),
            _gap_row("flag_mismatch", flags, limits)]


def passed(rows: list) -> bool:
    return all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
               for r in rows)
