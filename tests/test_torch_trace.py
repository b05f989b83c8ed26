"""The port's layer spans (`ddiffpg_tpu_torch/utils/trace.py`) on the CPU.

Off, a span makes no profiler call (`record_function` patched to raise)
while a DDiffPG train iteration and a collect step run. On, a CPU
torch.profiler session sees the spans nested as the layers are: a train
iteration's `train_step` > `env_step` > `actor`, `env`, `replay_add` and
`train_step` > `update_pass` > its seven parts in order; a collect step's
`collect_step` > `actor`, `env` > `physics` (and `ee_state` on Panda).
Outputs and states are bitwise the same with the spans on and off. The
`mark` hook of all four agents' update passes is called with the same
part names in the same order, spans on or off. Tiny sizes, one intra-op
thread; the collect steps' plain substep stands still (returns its
state), since on the CPU it is most of their time and the profiler's.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

from ddiffpg_tpu_torch import config as C  # noqa: E402
from ddiffpg_tpu_torch.agents import make_agent  # noqa: E402
from ddiffpg_tpu_torch.agents.ddiffpg import collect  # noqa: E402
from ddiffpg_tpu_torch.envs import base as env_base  # noqa: E402
from ddiffpg_tpu_torch.envs import make  # noqa: E402
from ddiffpg_tpu_torch.models.diffusion import DiffusionPolicy  # noqa: E402
from ddiffpg_tpu_torch.parallel.dp import leaves  # noqa: E402
from ddiffpg_tpu_torch.utils import trace  # noqa: E402
from tests.port_fixtures import (  # noqa: E402,F401
    fresh_structure_cache, one_torch_thread)

DDIFFPG_PARTS = ["sample", "NovelD reward", "target actions",
                 "critic update", "action gradient", "actor loss and step",
                 "RND update"]
# the part names each agent's `mark` hook is called with, in order
PARTS = {"DDiffPG": DDIFFPG_PARTS,
         "TD3": ["sample", "critic update", "RND update", "actor update",
                 "soft targets"],
         "SAC": ["sample", "critic update", "RND update", "actor update",
                 "alpha and soft targets"],
         "DIPO": ["sample", "critic update", "RND update", "action gradient",
                  "actor loss and step", "soft targets"]}


@pytest.fixture(autouse=True)
def spans_off():
    """The spans off after each test."""
    yield
    trace.enable(False)


def _refuse(*a, **k):
    raise AssertionError("a span called the profiler while off")


@pytest.fixture
def no_profiler_calls(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)


def _agent(algo: str):
    cfg = C.Config(algo=C.algo_preset(algo.lower())).override(
        **{"env.name": "pointmaze-v1"})
    cfg = C.preprocess(cfg, if_ddiffpg=algo == "DDiffPG").override(
        **{"num_envs": 4, "algo.batch_size": 48, "algo.memory_size": 8,
           "algo.warm_up": 3, "algo.update_times": 2,
           "diffusion.update_times": 2, "diffusion.diffusion_iter": 2})
    env = make("pointmaze-v1", num_envs=4, device="cpu")
    agent = make_agent(algo, env, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return agent, agent.warmup(agent.init(seed=0))


def _profiled(fn):
    """fn()'s result, and the spans a CPU profiler session saw:
    [(name, start ns, end ns)] by start."""
    trace.enable(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    trace.enable(False)
    spans = [(e.name()[len(trace.PREFIX):], e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _children(spans) -> dict:
    """{parent name: [child names in order]} of nested spans (the root's
    children under None)."""
    kids, stack = {}, []
    for name, s, e in spans:
        while stack and stack[-1][2] < e:
            stack.pop()
        kids.setdefault(stack[-1][0] if stack else None, []).append(name)
        stack.append((name, s, e))
    return kids


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path


def test_off_returns_one_shared_context(no_profiler_calls):
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b") is trace.part("c")
    with trace.span("a"), trace.part("c"):
        pass
    called = []
    with trace.part("c", called.append):
        assert called == []
    assert called == ["c"]


def test_train_iter_spans_nest_and_change_nothing(monkeypatch):
    agent, ts = _agent("DDiffPG")
    g0 = agent.generator.get_state()
    e0 = agent.env.env.generator.get_state()
    ts0 = copy.deepcopy(ts)
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _refuse)
        ts_off, logs_off = agent.train_iter(ts, 3)
    agent.generator.set_state(g0)
    agent.env.env.generator.set_state(e0)
    (ts_on, logs_on), spans = _profiled(lambda: agent.train_iter(ts0, 3))
    _same(ts_off, ts_on)
    assert list(logs_off) == list(logs_on)
    _same(list(logs_off.values()), list(logs_on.values()))

    kids = _children(spans)
    n = agent.cfg.algo.update_times
    assert kids[None] == ["train_step"]
    assert kids["train_step"] == ["env_step"] + ["update_pass"] * n
    assert kids["env_step"] == ["actor", "env", "replay_add"]
    assert kids["update_pass"] == DDIFFPG_PARTS * n


@pytest.mark.parametrize("name,env_kids", [
    ("antmaze-v1", ["physics"]),
    ("PandaDrawerMultiJoints-v3", ["physics", "ee_state"])],
    ids=["ant", "panda"])
def test_collect_spans_nest_and_change_nothing(monkeypatch, name, env_kids):
    # the plain substep, most of a CPU env step, stands still here: the
    # spans do not depend on it
    monkeypatch.setattr(env_base, "substep_reference",
                        lambda consts, qpos, qvel, ctrl: (qpos, qvel))
    env = make(name, num_envs=1, device="cpu")
    policy = DiffusionPolicy(env.action_dim, env.obs_dim + 4, 2,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    emb = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))
    state, obs = env.reset()

    def run():
        gen = torch.Generator().manual_seed(2)
        env.env.generator.manual_seed(3)
        return collect(env, policy, state, obs, 1, 0.5, emb,
                       torch.tensor(2), 0.1, 0.3, generator=gen)

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _refuse)
        off = run()
    on, spans = _profiled(run)
    _same(list(off), list(on))
    kids = _children(spans)
    assert kids[None] == ["collect_step"]
    assert kids["collect_step"] == ["actor", "env"]
    assert kids["env"] == env_kids


@pytest.fixture(scope="module")
def agents():
    """Each agent and its warmed-up state, built once for the module."""
    return {}


@pytest.mark.parametrize("algo", sorted(PARTS))
@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_mark_keeps_its_names_and_order(agents, algo, on):
    if algo not in agents:
        agents[algo] = _agent(algo)
    agent, ts = agents[algo]
    trace.enable(on)
    called = []
    agents[algo] = (agent, agent.update_once(ts, mark=called.append)[0])
    assert called == PARTS[algo]


@pytest.mark.parametrize("name,n_ik", [("PandaDrawerMulti-v3", 1),
                                       ("PandaDrawerMultiJoints-v3", 0)],
                         ids=["ee", "joints"])
def test_panda_step_ik_span_encloses_the_ik(monkeypatch, name, n_ik):
    # one env step at B = 4: the `ee` control records one `ik` span, which
    # encloses the control's FK and the DLS IK (probed by ranges of their
    # own) and closes before the physics; the joints control records none
    monkeypatch.setattr(env_base, "substep_reference",
                        lambda consts, qpos, qvel, ctrl: (qpos, qvel))
    env = make(name, num_envs=4, device="cpu")
    arm = env.env.arm
    for obj, fn in ((arm, "dls_ik"), (arm.kin, "fk")):
        def probed(*a, _f=getattr(obj, fn), _n=fn, **k):
            with torch.profiler.record_function(trace.PREFIX + "probe " + _n):
                return _f(*a, **k)
        monkeypatch.setattr(obj, fn, probed)
    state, _ = env.reset()
    action = torch.rand((4, env.action_dim),
                        generator=torch.Generator().manual_seed(0)) * 2 - 1
    _, spans = _profiled(lambda: env.step(state, action))
    ik = [s for s in spans if s[0] == "ik"]
    assert len(ik) == n_ik
    kids = _children(spans)
    if n_ik:
        # the control's FK, then dls_ik with an FK in each of its 3 steps
        assert kids["ik"] == ["probe fk", "probe dls_ik"]
        assert kids["probe dls_ik"] == ["probe fk"] * 3
        physics = [s for s in spans if s[0] == "physics"]
        assert ik[0][2] <= physics[0][1]
    assert kids["env"] == ["ik"] * n_ik + ["physics", "ee_state"]
    assert "probe dls_ik" not in kids[None] + kids["env"]
