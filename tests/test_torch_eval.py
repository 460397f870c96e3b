"""The PyTorch port's client role against the JAX package's, on the CPU: the
Simpler, ManiSkill3 and LIBERO evaluators driven by one scripted client over
the same fake simulators, the host modules they use (image tools, language
mapper, EDR and LIBERO adapters, task suites), the adapters' cv2-free path for
frames already at the model's size, and W&B through the gate (the evaluators
and the trainer).

No socket is opened here (tests/test_torch_eval_wire.py drives the wire). The
JAX evaluators are reached read-only: their websocket client is replaced by
monkeypatching the module attribute their base class constructs.
"""

import copy
import dataclasses
import json
import logging
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
STATS = str(REPO / "config/dataset/bridge_statistics.json")
METRICS = {"Success Rate", "Move Correct", "Wrong Obj Attempt", "Grasp Correct", "Src Intention Correct"}


# ---------------------------------------------------------------------------
# fakes shared by both packages
# ---------------------------------------------------------------------------

class ScriptedClient:
    """The policy client's surface: chunks of env actions drawn from a seeded
    generator (xyz and rotation small, gripper +-1), every request recorded."""

    def __init__(self, shape, seed=0):
        self.shape = shape
        self.rng = np.random.default_rng(seed)
        self.obs, self.events = [], []

    def infer(self, obs):
        self.obs.append(copy.deepcopy(obs))
        chunk = self.rng.uniform(-0.03, 0.03, self.shape)
        chunk[..., 6] = np.where(self.rng.random(self.shape[:-1]) < 0.5, -1.0, 1.0)
        return chunk

    def reset(self):
        self.events.append("reset")
        return {"status": "reset"}

    def switch_model(self, path):
        self.events.append(("switch", path))
        return {"status": "model switched"}


class FakeWandb(types.ModuleType):
    """A `wandb` module that records each run's init arguments and logs."""

    def __init__(self):
        super().__init__("wandb")
        self.runs = []

    def init(self, **kwargs):
        run = types.SimpleNamespace(id=kwargs["id"], kwargs=kwargs, logged=[], finish=lambda: None)
        run.log = lambda data, step=None: run.logged.append((dict(data), step))
        self.runs.append(run)
        return run


def simpler_env_cls():
    from intact_tpu_torch.envs.evaluators.fake import FakeSimplerEnv

    class RecordingSimplerEnv(FakeSimplerEnv):
        """The fake Simpler env with frames that change every step, recording
        every action it is stepped with."""

        def __init__(self, task_name, image_size=32):
            super().__init__(task_name, image_size)
            self.stepped = []

        def step(self, action):
            self.stepped.append(np.array(action))
            return super().step(action)

        def _obs(self):
            obs = super()._obs()
            rng = np.random.default_rng((self._episode_id, self._t))
            obs["image"] = rng.integers(0, 256, obs["image"].shape, dtype=np.uint8)
            return obs

    return RecordingSimplerEnv


class FakeBatchEnv:
    """Vectorized ManiSkill3 stand-in: n envs whose end effectors move with the
    actions, truncated together after `steps`, with per-env episode stats."""

    def __init__(self, n, steps=8):
        self.n, self.steps = n, steps
        self.stepped, self.resets = [], []

    @property
    def unwrapped(self):
        return self

    def get_language_instruction(self):
        return "put the spoon on the towel"

    def reset(self, seed=None, options=None):
        self.resets.append((list(seed), np.asarray(options["episode_id"]).tolist(), options["reconfigure"]))
        self._t, self._seed = 0, int(sum(seed))
        self._pos = np.asarray(seed, np.float64)[:, None] * 1e-3 * np.ones((self.n, 3))
        return self._obs(), {}

    def step(self, action):
        action = np.asarray(action)
        assert action.shape == (self.n, 7)
        self.stepped.append(action.copy())
        self._pos = self._pos + action[:, :3]
        self._t += 1
        truncated = np.full(self.n, self._t >= self.steps)
        info = {}
        if truncated.all():
            rng = np.random.default_rng(self._seed)
            info = {"episode_stats": {k: rng.integers(0, 2, self.n) for k in
                                      ("moved_correct_obj", "moved_wrong_obj", "is_src_obj_grasped",
                                       "source_intention")},
                    "success": rng.random(self.n) < 0.5}
        return self._obs(), 0.0, np.zeros(self.n, bool), truncated, info

    def _obs(self):
        eef = np.concatenate([self._pos, np.tile([1.0, 0, 0, 0], (self.n, 1)), np.full((self.n, 1), 0.5)], axis=1)
        return {"agent": {"eef_pos": eef}}


def batch_image_getter(env, obs):
    rng = np.random.default_rng((env._seed, env._t))
    return rng.integers(0, 256, (env.n, 20, 20, 3), dtype=np.uint8)


class FakeLiberoTask:
    def __init__(self, task_id):
        self.bddl_file = f"task{task_id}.bddl"
        self.language = ["pick up the cube and place it in the basket", "put the carrot on the plate"][task_id % 2]


class FakeLiberoSuite:
    n_tasks = 2

    def get_task(self, task_id):
        return FakeLiberoTask(task_id)

    def get_task_init_states(self, task_id):
        return [np.full(4, task_id), np.full(4, task_id + 10)]


class FakeLiberoEnv:
    """LIBERO stand-in: non-square agentview frames that change every step (and
    tell a 180-degree flip apart), an end effector moved by the actions, done
    after `done_at` steps; with `raise_at` (episode, step) it raises there."""

    def __init__(self, task_id, done_at=22, raise_at=None):
        self.task_id, self.done_at, self.raise_at = task_id, done_at, raise_at
        self.episode, self.stepped = -1, []

    def reset(self):
        self.episode += 1
        self._t = 0

    def set_init_state(self, state):
        self._pos = np.asarray(state[:3], np.float64) * 1e-2
        return self._obs()

    def step(self, action):
        if self.raise_at == (self.episode, self._t):
            raise RuntimeError("simulator lost its contact solver")
        self.stepped.append(np.array(action, np.float64))
        self._pos = self._pos + np.asarray(action[:3])
        self._t += 1
        return self._obs(), 0.0, self._t >= self.done_at, {}

    def close(self):
        pass

    def _obs(self):
        rng = np.random.default_rng((self.task_id, self.episode, self._t))
        return {
            "agentview_image": rng.integers(0, 256, (40, 48, 3), dtype=np.uint8),
            "robot0_eef_pos": self._pos.copy(),
            "robot0_eef_quat": np.array([0.1, 0.2, 0.3, 0.9]) / np.linalg.norm([0.1, 0.2, 0.3, 0.9]),
            "robot0_gripper_qpos": np.array([0.03, -0.02 - 1e-3 * self._t]),
        }


# ---------------------------------------------------------------------------
# one evaluator run per package
# ---------------------------------------------------------------------------

def make_cfg(pipe, sim="simpler", **eval_kw):
    """A client-role config of either package (`pipe` is its config.pipeline)."""
    kw = dict(simulator_name=sim, task_list=["widowx_carrot_on_plate"], n_eval_episode=2, n_video=0,
              recording=False, role="client", action_step=4)
    kw.update(env_adapter={"simpler": "BridgeSimplerAdapter", "simplerMS3": "BatchBridgeSimplerAdapter",
                           "libero": "LiberoAdapter"}[sim])
    kw.update(eval_kw)
    return pipe.TrainPipelineConfig(name="eval_test", model_cfg={"type": "pi0_tiny"}, use_bf16=False,
                                    use_wandb=True, eval_cfg=pipe.EvalConfig(**kw),
                                    env=pipe.EnvConfig(dataset_statistics_path=STATS, image_size=(28, 28)))


def read_logs(root: Path) -> tuple[list, list]:
    """-> (every file under root, relative, with the timestamp directory
    masked; every eval.log line as (logger, level, message), the time line
    of the summary masked)."""
    stamp = re.compile(r"^\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}$")
    files, lines = [], []
    for path in sorted(root.rglob("*")):
        if not path.is_file():
            continue
        rel = "/".join("<ts>" if stamp.match(part) else part for part in path.relative_to(root).parts)
        files.append(rel)
        if path.name == "eval.log":
            for line in path.read_text().splitlines():
                _, name, level, message = line.split(" - ", 3)
                if message.startswith("Total Task Eval Time: "):
                    message = re.sub(r"[\d.]+ minutes$", "<t> minutes", message)
                lines.append((rel, name, level, message))
    return sorted(files), lines


def close_eval_loggers():
    for name in list(logging.root.manager.loggerDict):
        if name.startswith("evaluator"):
            for h in list(logging.getLogger(name).handlers):
                logging.getLogger(name).removeHandler(h)
                h.close()


def run_evaluator(side, sim, monkeypatch, tmp_path, cfg_kw, make_env, client_shape, seed=0):
    """Run one package's evaluator of `sim` -> its results, client, envs,
    W&B runs, files and log lines."""
    if side == "jax":
        from intact_tpu.config import pipeline as pipe
        from intact_tpu.envs.evaluators import base, libero, simpler, simplerMS3
    else:
        from intact_tpu_torch.config import pipeline as pipe
        from intact_tpu_torch.envs.evaluators import base, libero, simpler, simplerMS3

    root = tmp_path / side
    monkeypatch.setenv("VLA_LOG_DIR", str(root))
    wandb = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setitem(sys.modules, "imageio", None)  # the .npz video path, as on the card
    client = ScriptedClient(client_shape, seed)
    kw = {}
    if side == "jax":
        monkeypatch.setattr(base, "WebsocketPolicyClient", lambda host, port: client)
    else:
        kw["client"] = client
    cfg = make_cfg(pipe, sim, **cfg_kw)
    envs = []

    def env(*args):
        envs.append(make_env(*args))
        return envs[-1]

    if sim == "simpler":
        ev = simpler.SimplerEvaluator(cfg, env_factory=env, image_getter=lambda e, obs: obs["image"], **kw)
    elif sim == "simplerMS3":
        ev = simplerMS3.SimplerMS3Evaluator(cfg, env_factory=env, image_getter=batch_image_getter, **kw)
    else:
        ev = libero.LiberoEvaluator(cfg, suite_factory=lambda name: FakeLiberoSuite(),
                                    env_factory=lambda task, res, s: (env(task, res, s), task.language), **kw)
    try:
        results = ev.evaluate()
    finally:
        close_eval_loggers()
    files, lines = read_logs(root)
    return dict(results=results, client=client, envs=envs, wandb=[r.logged for r in wandb.runs], files=files,
                lines=lines)


def assert_same(a, b, path="obs"):
    """Recursive exact equality of nested dicts/lists of arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, path


def run_both(sim, monkeypatch, tmp_path, cfg_kw, make_env, client_shape):
    runs = {side: run_evaluator(side, sim, monkeypatch, tmp_path, cfg_kw, make_env, client_shape)
            for side in ("jax", "torch")}
    j, t = runs["jax"], runs["torch"]
    assert t["results"] == j["results"]
    assert_same(t["client"].obs, j["client"].obs)
    assert t["client"].events == j["client"].events
    assert len(t["envs"]) == len(j["envs"])
    for te, je in zip(t["envs"], j["envs"]):
        assert_same(te.stepped, je.stepped, "stepped")
        assert_same(getattr(te, "resets", []), getattr(je, "resets", []), "resets")  # MS3's seeds and episode ids
    assert t["files"] == j["files"]
    assert t["lines"] == j["lines"]
    assert t["wandb"] == j["wandb"]
    return t


# ---------------------------------------------------------------------------
# (a) evaluator parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,cfg_kw", [
    ("plain", {}),
    ("language_logic_chain", {"language_logic_chain": True}),
    ("recording", {"recording": True, "n_video": 1}),
    ("google_robot_table", {"task_list": ["google_robot_pick_coke_can"], "n_eval_episode": 3}),
    ("checkpoint_sweep", {"pretrained_model_path": "ckpts", "pretrained_model_gradient_step_cnt": [1, 2],
                          "task_list": ["widowx_carrot_on_plate", "widowx_spoon_on_towel"], "n_eval_episode": 1}),
])
def test_simpler_evaluator_matches_jax(case, cfg_kw, monkeypatch, tmp_path):
    """SimplerEvaluator: the receding-horizon deque (first action_step rows of
    each chunk, re-inferred when drained), episode enumeration, the metrics,
    the log lines and layout, the videos, W&B's per-task log."""
    t = run_both("simpler", monkeypatch, tmp_path, cfg_kw, simpler_env_cls(), (4, 7))
    tasks = cfg_kw.get("task_list", ["widowx_carrot_on_plate"])
    steps = cfg_kw.get("pretrained_model_gradient_step_cnt") or [0]
    # google-robot suites take their episode count from the reference's table, not n_eval_episode
    episodes = 100 if case == "google_robot_table" else cfg_kw.get("n_eval_episode", 2)
    assert len(t["client"].obs) == len(steps) * len(tasks) * episodes * 24 // 4
    assert t["client"].events.count("reset") == len(steps) * len(tasks) * episodes
    for task in tasks:
        assert set(t["results"][task]) == METRICS and all(0 <= v <= 1 for v in t["results"][task].values())
    for step in steps:
        assert any(f.startswith(f"eval_online/simpler/eval_test/step_{step}/ta_4/42/<ts>/eval.log")
                   for f in t["files"])
    summary = [m for _, _, _, m in t["lines"]]
    assert "============ Evaluation Summary ============" in summary and "Total Task Eval Time: <t> minutes" in summary
    if case == "recording":
        videos = [f.rsplit("/", 1)[1] for f in t["files"] if "/videos/" in f]
        assert videos in (["video_0.npz"], ["video_0_success.npz"])
    if case == "language_logic_chain":
        assert all(o["task"] != "put the carrot on the plate" for o in t["client"].obs)
    first = t["client"].obs[0]
    assert first["observation.images.top"].shape == (32, 32, 3) and set(first) == {
        "observation.images.top", "observation.state", "task"}


@pytest.mark.parametrize("case,cfg_kw", [
    ("two_batches", {"n_eval_episode": 6}),
    ("sweep_recording_wandb", {"n_eval_episode": 3, "recording": True, "n_video": 3, "pretrained_model_path": "ckpts",
                               "pretrained_model_gradient_step_cnt": [1, 2]}),
])
def test_simplerMS3_evaluator_matches_jax(case, cfg_kw, monkeypatch, tmp_path):
    """SimplerMS3Evaluator over 3 parallel envs: [N, action_step, dim] chunks
    stepped as per-step [N, dim] actions, per-env metrics, the off-thread
    videos, and W&B buffered and flushed once per checkpoint."""
    kw = {"n_parallel_eval": 3, **cfg_kw}
    t = run_both("simplerMS3", monkeypatch, tmp_path, kw, lambda task, n, seed: FakeBatchEnv(n), (3, 4, 7))
    steps = cfg_kw.get("pretrained_model_gradient_step_cnt") or [0]
    batches = cfg_kw["n_eval_episode"] // 3
    assert len(t["client"].obs) == len(steps) * batches * 2
    assert t["client"].obs[0]["observation.state"].shape == (3, 8)
    assert [s for _, s in t["wandb"][0]] == [step or 0 for step in steps]
    assert all(set(d) == {"eval/widowx_carrot_on_plate/Success Rate"} for d, _ in t["wandb"][0])
    if cfg_kw.get("recording"):
        videos = [f.rsplit("/", 1)[1].split(".")[0].split("_")[1] for f in t["files"] if "/videos/" in f]
        assert sorted(videos) == sorted(["0", "1", "2"] * len(steps))


@pytest.mark.parametrize("case,cfg_kw,raise_at", [
    ("recording", {"recording": True}, None),
    ("language_logic_chain", {"language_logic_chain": True}, None),
    ("env_raises_mid_episode", {"recording": True}, (1, 15)),
])
def test_libero_evaluator_matches_jax(case, cfg_kw, raise_at, monkeypatch, tmp_path):
    """LiberoEvaluator over a 2-task suite, 2 episodes each: the 10 settle
    steps, the 180-degree flip and resize_with_pad (PIL) of a non-square frame,
    the proprio (wxyz quaternion, gripper openness), the deque, the videos;
    an env that raises abandons that episode, counted as a failure in both."""
    kw = {"task_list": ["libero_spatial"], **cfg_kw}

    def make_env(task, res, seed):
        return FakeLiberoEnv(int(task.bddl_file[4]), raise_at=raise_at if task.bddl_file == "task0.bddl" else None)

    t = run_both("libero", monkeypatch, tmp_path, kw, make_env, (4, 7))
    # 12 policy steps (3 chunks) per episode; the broken one ends after 5 (2 chunks)
    inferences = 4 * 3 - (1 if raise_at else 0)
    assert len(t["client"].obs) == inferences and t["client"].events.count("reset") == 4
    assert t["client"].obs[0]["observation.images.top"].shape == (28, 28, 3)
    sr = t["results"]["libero_spatial"]["Success Rate"]
    assert sr == (0.75 if raise_at else 1.0)
    warnings = [m for _, _, level, m in t["lines"] if level == "WARNING"]
    assert warnings == (["episode error: RuntimeError('simulator lost its contact solver')"] if raise_at else [])


def test_libero_frame_is_the_env_frame_flipped(monkeypatch, tmp_path):
    """The frame LIBERO sends is the agentview frame rotated 180 degrees (at
    the model's size no resize runs)."""
    from intact_tpu_torch.config import pipeline as tpipe
    from intact_tpu_torch.envs.evaluators.libero import LiberoEvaluator

    monkeypatch.setenv("VLA_LOG_DIR", str(tmp_path))
    seen = []

    class SquareEnv(FakeLiberoEnv):
        def _obs(self):
            obs = super()._obs()
            obs["agentview_image"] = np.random.default_rng(self._t).integers(0, 256, (28, 28, 3), dtype=np.uint8)
            seen.append(obs["agentview_image"])
            return obs

    client = ScriptedClient((4, 7))
    cfg = make_cfg(tpipe, "libero", task_list=["libero_spatial"], n_eval_episode=1)
    ev = LiberoEvaluator(cfg, suite_factory=lambda name: FakeLiberoSuite(),
                         env_factory=lambda task, res, s: (SquareEnv(0), task.language), client=client)
    try:
        ev.evaluate()
    finally:
        close_eval_loggers()
    sent = client.obs[0]["observation.images.top"]
    assert not np.array_equal(sent, seen[10]) and np.array_equal(sent, seen[10][::-1, ::-1])


# ---------------------------------------------------------------------------
# (b) host modules against the JAX package's, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,target,dtype", [
    ((40, 48, 3), (28, 28), np.uint8),
    ((2, 30, 50, 3), (24, 32), np.uint8),
    ((28, 28, 3), (28, 28), np.uint8),
    ((3, 64, 20, 3), (16, 16), np.uint8),
    ((33, 17, 3), (33, 17), np.float32),
])
def test_image_tools_match_jax(shape, target, dtype):
    from intact_tpu.protocol import image_tools as jit_
    from intact_tpu_torch.protocol import image_tools as tit

    rng = np.random.default_rng(sum(shape))
    if dtype == np.uint8:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        img = rng.random(shape, dtype=np.float32)
    got, want = tit.resize_with_pad(img, *target), jit_.resize_with_pad(img, *target)
    assert got.shape == want.shape == (*shape[:-3], *target, 3)
    assert_same(got, want)
    assert_same(tit.convert_to_uint8(img), jit_.convert_to_uint8(img))
    assert_same(tit.convert_to_uint8(img.astype(np.float64) / 2), jit_.convert_to_uint8(img.astype(np.float64) / 2))
    if img.dtype == np.uint8 and img.ndim == 3 and shape[:2] != target:
        from PIL import Image

        nearest = tit.resize_with_pad(img, *target, method=Image.NEAREST)
        assert_same(nearest, jit_.resize_with_pad(img, *target, method=Image.NEAREST))


def test_resize_with_pad_at_the_target_size_needs_no_pil(monkeypatch):
    from intact_tpu_torch.protocol import image_tools as tit

    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.arange(28 * 28 * 3, dtype=np.uint8).reshape(28, 28, 3)
    assert tit.resize_with_pad(img, 28, 28) is img
    with pytest.raises(ImportError):
        tit.resize_with_pad(img, 14, 14)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_language_mapper_matches_jax(seed):
    from intact_tpu.envs.adapters.language_mapper import PersistentLanguageMapper as J
    from intact_tpu_torch.envs.adapters.language_mapper import PersistentLanguageMapper as T

    j, t = J(seed=seed), T(seed=seed)
    texts = ["put the carrot on the plate", "put eggplant into the basket", "stack the green cube", "lift the spoon"]
    for episode in [None, None, 5, None, 0]:
        j.reset(episode), t.reset(episode)
        assert t._mapping == j._mapping and [t.map(s) for s in texts] == [j.map(s) for s in texts]


def adapter_cfgs(image_size=(28, 28), norm="bound", stats=STATS):
    from intact_tpu.config import pipeline as jpipe
    from intact_tpu_torch.config import pipeline as tpipe

    def cfg(pipe):
        c = make_cfg(pipe, "simpler")
        c.env = pipe.EnvConfig(dataset_statistics_path=stats, image_size=image_size, action_normalization_type=norm,
                               state_normalization_type=norm)
        return c

    return cfg(jpipe), cfg(tpipe)


@pytest.mark.parametrize("name", ["EDRSimplerAdapter", "EDREulerSimplerAdapter"])
@pytest.mark.parametrize("norm", ["bound", "gaussian"])
def test_edr_adapters_match_jax(name, norm):
    """preprocess (uint8 frames as the serving session asks, proprio, task)
    and postprocess over 40 steps of chunks: the sticky gripper's state
    carries across calls the same way."""
    from intact_tpu.envs.adapters import simpler as jsim
    from intact_tpu_torch.envs.adapters import simpler as tsim

    # EDR's proprio is 8-d (xyzw quaternion): the Fractal statistics; the euler variant's is 7-d
    stats = str(REPO / "config/dataset/fractal_statistics.json") if name == "EDRSimplerAdapter" else STATS
    jcfg, tcfg = adapter_cfgs(norm=norm, stats=stats)
    j, t = getattr(jsim, name)(jcfg), getattr(tsim, name)(tcfg)
    j.output_uint8 = t.output_uint8 = True
    rng = np.random.default_rng(3)
    for _ in range(3):
        quat = rng.normal(size=4)
        obs = {"observation.images.top": rng.integers(0, 256, (48, 40, 3), dtype=np.uint8),
               "observation.state": {"agent": {"eef_pos": np.concatenate([rng.normal(size=3) * 0.1,
                                                                          quat / np.linalg.norm(quat), [0.3]])}},
               "task": "pick coke can"}
        assert_same(t.preprocess(obs), j.preprocess(obs))
    outs = []
    for step in range(10):  # 10 chunks of 4 steps: 40 sticky-gripper updates
        actions = rng.uniform(-1, 1, (4, 7)).astype(np.float32)
        actions[:, 6] = rng.choice([0.0, 0.1, 0.5, 0.9, 1.0], 4)
        got, want = t.postprocess(actions), j.postprocess(actions)
        assert_same(got, want)
        outs.append(got[:, 6])
        if step == 5:
            j.reset(), t.reset()
    assert {t.sticky_action_is_on, t.gripper_action_repeat} == {j.sticky_action_is_on, j.gripper_action_repeat}
    assert len(set(np.concatenate(outs).tolist())) > 1


@pytest.mark.parametrize("name", ["LiberoAdapter", "TacoLiberoAdapter"])
@pytest.mark.parametrize("norm", ["bound", "gaussian"])
def test_libero_adapters_match_jax(name, norm, monkeypatch):
    """preprocess (cv2 Lanczos resize, [-1, 1] frame, proprio) and postprocess
    bit-equal. Both packages normalize with their C++ fastops, built with the
    same flags: x * scale + offset contracts into a fused multiply-add
    (-march=native), one float32 ulp away from the JAX package's numpy path."""
    from intact_tpu import native
    from intact_tpu.envs.adapters import libero as jlib
    from intact_tpu_torch.envs.adapters import libero as tlib

    jcfg, tcfg = adapter_cfgs(norm=norm)
    j, t = getattr(jlib, name)(jcfg), getattr(tlib, name)(tcfg)
    rng = np.random.default_rng(5)
    quat = rng.normal(size=4)
    obs = {"observation.images.top": rng.integers(0, 256, (40, 48, 3), dtype=np.uint8),
           "observation.state": np.concatenate([rng.normal(size=3) * 0.1, quat / np.linalg.norm(quat), [0.7]]),
           "task": "open the drawer"}
    fused = j.preprocess(obs)  # the JAX package's native path
    got = t.preprocess(obs)
    assert_same(got, fused)
    monkeypatch.setattr(native, "_LIB_CACHE", [None, True])  # the JAX package's numpy path
    assert np.abs(got["image"] - j.preprocess(obs)["image"]).max() <= 2.0 ** -23
    actions = rng.normal(size=(4, 7)).astype(np.float32)
    assert_same(t.postprocess(actions), j.postprocess(actions))
    for widths in ([0.03, -0.03], [0.01, -0.03], [0.016, 0.02]):
        assert t.gripper_state_from_widths(widths) == j.gripper_state_from_widths(widths)


def test_task_suites_match_jax():
    from intact_tpu.envs import tasks as jtasks
    from intact_tpu_torch.envs import tasks as ttasks

    assert ttasks.SUITES == jtasks.SUITES and len(ttasks.FULL_SUITE) == 51
    for name in ttasks.SUITES:
        assert ttasks.get_suite(name) == jtasks.get_suite(name)
        ttasks.get_suite(name).append("x")  # a copy: the suite stays as it was
        assert ttasks.get_suite(name) == jtasks.get_suite(name)
    with pytest.raises(KeyError, match="unknown task suite 'nope'"):
        ttasks.get_suite("nope")


def test_fake_env_matches_jax():
    from intact_tpu.envs.evaluators import fake as jfake
    from intact_tpu_torch.envs.evaluators import fake as tfake

    j, t = jfake.fake_env_factory("widowx_carrot_on_plate"), tfake.fake_env_factory("widowx_carrot_on_plate")
    opts = {"obj_init_options": {"episode_id": 3}}
    assert_same(t.reset(seed=5, options=opts), j.reset(seed=5, options=opts))
    rng = np.random.default_rng(0)
    for _ in range(24):
        a = rng.uniform(-0.02, 0.02, 7)
        a[6] = 1.0
        assert_same(t.step(a), j.step(a))
    assert_same(tfake.fake_image_getter(t, t._obs()), jfake.fake_image_getter(j, j._obs()))


# ---------------------------------------------------------------------------
# (c) the adapters skip cv2 for a frame already at the model's size
# ---------------------------------------------------------------------------

IMAGE_SIZE = (24, 32)  # non-square: cv2's dsize is (width, height), so such frames are 32 x 24


def equal_size_cases():
    from intact_tpu_torch.envs.adapters.libero import LiberoAdapter
    from intact_tpu_torch.envs.adapters.simpler import BridgeSimplerAdapter
    from intact_tpu_torch.envs.adapters.simplerMS3 import BatchBridgeSimplerAdapter

    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (IMAGE_SIZE[1], IMAGE_SIZE[0], 3), dtype=np.uint8)
    eef = np.array([0.1, 0.2, 0.3, 1.0, 0, 0, 0, 0.8])
    return {
        "bridge": (BridgeSimplerAdapter, {"observation.images.top": frame,
                                          "observation.state": {"agent": {"eef_pos": eef}}, "task": "t"}),
        "batch": (BatchBridgeSimplerAdapter, {"observation.images.top": np.stack([frame, frame[::-1]]),
                                              "observation.state": np.stack([eef, eef]), "task": "t"}),
        "libero": (LiberoAdapter, {"observation.images.top": frame, "observation.state": eef, "task": "t"}),
    }


@pytest.mark.parametrize("kind,uint8", [("bridge", False), ("bridge", True), ("batch", False), ("batch", True),
                                        ("libero", False)])  # LiberoAdapter has no uint8 output, as in the reference
def test_equal_size_frame_skips_cv2(kind, uint8, monkeypatch):
    """At image_size the adapters return what cv2's Lanczos resize returns
    there (a copy), and run with cv2 unimportable; at another size they run
    without cv2 too (the port's codec computes cv2's Lanczos4) and return what
    cv2 returns."""
    import cv2

    from intact_tpu_torch.native import normalize_u8

    cls, obs = equal_size_cases()[kind]
    _, tcfg = adapter_cfgs(image_size=IMAGE_SIZE)
    adapter = cls(tcfg)
    adapter.output_uint8 = uint8
    frames = obs["observation.images.top"]
    frames = frames if frames.ndim == 4 else frames[None]
    want = np.stack([cv2.resize(f, IMAGE_SIZE, interpolation=cv2.INTER_LANCZOS4) for f in frames])
    assert want.shape[1:3] == frames.shape[1:3]  # cv2 keeps the frame: the frame is at image_size
    with_cv2 = adapter.preprocess(obs)
    monkeypatch.setitem(sys.modules, "cv2", None)
    without = adapter.preprocess(obs)
    assert_same(without, with_cv2)
    assert_same(without["image"], want if uint8 else normalize_u8(want))
    assert not np.shares_memory(without["image"], obs["observation.images.top"])
    taller = np.concatenate([frames, frames], axis=1)
    other = dict(obs, **{"observation.images.top": taller if kind == "batch" else taller[0]})
    resized = np.stack([cv2.resize(f, IMAGE_SIZE, interpolation=cv2.INTER_LANCZOS4) for f in taller])
    want_other = resized if uint8 else normalize_u8(resized)
    got = adapter.preprocess(other)["image"]  # cv2 still unimportable
    assert_same(got, want_other if kind == "batch" else want_other[:1])


# ---------------------------------------------------------------------------
# (d) W&B through the gate
# ---------------------------------------------------------------------------

def test_wandb_gate_without_wandb_is_a_noop_run(monkeypatch):
    from intact_tpu_torch.utils import wandb_gate

    monkeypatch.setitem(sys.modules, "wandb", None)
    run = wandb_gate.init(True, "p", name="n", run_id="abc")
    assert type(run).__name__ == "_NoopRun" and run.id == "abc"
    run.log({"x": 1.0}, step=3)
    run.finish()
    minted = wandb_gate.init(False, "p")
    assert type(minted).__name__ == "_NoopRun" and len(minted.id) == 8
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert type(wandb_gate.init(False, "p")).__name__ == "_NoopRun" and not fake.runs
    run = wandb_gate.init(True, "proj", name="n", entity="e", run_id="r1", config={"a": 1})
    assert fake.runs == [run] and run.kwargs == {"project": "proj", "name": "n", "entity": "e", "id": "r1",
                                                 "resume": "allow", "config": {"a": 1}}


def test_trainer_logs_each_update_and_keeps_its_run_id_on_resume(monkeypatch, tmp_path):
    """A tiny two-update Trainer run logs the train metrics and the learning
    rate at each update and the validation means, saves its W&B run id with
    the checkpoint; a resume from it logs on to the same run id."""
    from intact_tpu_torch import run as run_mod
    from intact_tpu_torch.config import pipeline
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.train import checkpoint as ckpt
    from intact_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(pipeline, "pi0_config_from_json", lambda d: dataclasses.replace(
        Pi0Config.tiny(), train_expert_only=True))
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)

    def cfg(**kw):
        over = {"mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 2, "n_updates": 2, "log_freq": 1,
                "eval_freq": 2, "eval_size": 2, "tokenizer_path": "hash", "log_dir": tmp_path, "use_wandb": "true",
                **kw}
        argv = ["--config_path", str(REPO / "config/train/pi0_finetune_bridge_expertonly.yaml")]
        for k, v in over.items():
            argv += [f"--{k}", str(v)]
        return run_mod.build_config(argv)[0]

    trainer = Trainer(cfg(), device="cpu")
    trainer.train()
    (run,) = fake.runs
    assert run.kwargs["project"] == trainer.cfg.wandb.project and run.kwargs["config"]["n_updates"] == 2
    train_logs = [(d, s) for d, s in run.logged if "learning rate" in d]
    assert [s for _, s in train_logs] == [1, 2] and all({"l2_loss", "grad_norm"} <= set(d) for d, _ in train_logs)
    val_logs = [(d, s) for d, s in run.logged if "l1_loss" in d]
    assert [s for _, s in val_logs] == [2] and len([k for k in val_logs[0][0] if k.startswith("acc@")]) == 5
    root = tmp_path / trainer.cfg.name / "checkpoint"
    assert ckpt.list_steps(root, committed_only=True) == [2]
    assert json.loads((root / "step_2" / ckpt.AUX_FILE).read_text())["wandb_id"] == run.id

    resumed = Trainer(cfg(n_updates=3, load_from_checkpoint=root / "step_2", resume_run="true"), device="cpu")
    assert resumed.cnt_update == 2 and fake.runs[1].id == run.id and resumed.cfg.wandb.run_id == run.id
    resumed.train()
    assert [s for d, s in fake.runs[1].logged if "learning rate" in d] == [3]
    Trainer(cfg(), device="cpu")  # a run that resumes nothing mints a new id
    assert fake.runs[2].id != run.id
