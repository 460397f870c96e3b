"""The PyTorch port's client role over the wire and through the run CLI, on
the CPU: the port's SimplerEvaluator drives the port's batching server (a
tiny Pi0 wrapper) over a real loopback websocket through a two-checkpoint
sweep, and `python -m intact_tpu_torch.run --eval_cfg.role client` resolves
and runs the port's evaluator.

Every wait is bounded: the evaluator runs in a daemon thread joined with a
time limit, and the server thread stops through its event loop.
"""

import functools
import sys
import threading
from pathlib import Path

import numpy as np

from tests.test_torch_serve_stack import WAIT_S, make_cfg, serve_batching

REPO = Path(__file__).resolve().parent.parent
METRICS = {"Success Rate", "Move Correct", "Wrong Obj Attempt", "Grasp Correct", "Src Intention Correct"}


def run_bounded(fn):
    """fn() in a daemon thread joined within WAIT_S -> its result; fails on a
    timeout or re-raises its exception."""
    out = {}

    def body():
        try:
            out["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout=WAIT_S)
    assert not t.is_alive(), f"the evaluator did not finish within {WAIT_S} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def test_simpler_evaluator_sweeps_checkpoints_over_a_websocket(tmp_path, monkeypatch):
    """Two committed step dirs written by the port's checkpoint writer; the
    evaluator switches the server to each (two swaps), runs one fake episode
    per checkpoint over the wire, and logs under step_1 and step_2."""
    from intact_tpu_torch.envs.evaluators.fake import fake_env_factory, fake_image_getter
    from intact_tpu_torch.envs.evaluators.simpler import SimplerEvaluator
    from intact_tpu_torch.models.pi0 import model as tpi0
    from intact_tpu_torch.serve.batching import BatchingPolicyServer
    from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper
    from intact_tpu_torch.train import checkpoint as ckpt

    monkeypatch.setenv("VLA_LOG_DIR", str(tmp_path / "log"))
    wrapper = Pi0PolicyWrapper(make_cfg(max_batch_size=4, batch_timeout_ms=5), device="cpu")
    root = tmp_path / "ckpt"
    for step in (1, 2):
        ckpt.save_checkpoint(root, tpi0.init(wrapper.model_cfg, seed=10 + step, device="cpu"), step=step)
    server = BatchingPolicyServer(wrapper, wrapper.config, metadata={"model": "pi0_tiny"}, max_batch_size=4,
                                  batch_timeout_ms=5, prewarm=False)
    st = serve_batching(server)
    swaps = []
    switch = wrapper.switch_model
    monkeypatch.setattr(wrapper, "switch_model", lambda path: (swaps.append(path), switch(path))[1])
    evaluator = {}
    try:
        cfg = make_cfg(port=st.port, pretrained_model_path=str(root), pretrained_model_gradient_step_cnt=[1, 2])
        cfg.eval_cfg.role, cfg.eval_cfg.n_eval_episode = "client", 1

        def evaluate():
            evaluator["ev"] = SimplerEvaluator(cfg, env_factory=fake_env_factory, image_getter=fake_image_getter)
            return evaluator["ev"].evaluate()

        results = run_bounded(evaluate)
    finally:
        if "ev" in evaluator:
            evaluator["ev"].client._ws.close_socket()  # abortive close: the server sees a dead peer at once
        st.stop()
    assert swaps == [str(root / "step_1"), str(root / "step_2")] and wrapper.model_generation == 2
    assert set(results["widowx_carrot_on_plate"]) == METRICS
    assert all(0 <= v <= 1 for v in results["widowx_carrot_on_plate"].values())
    for step in (1, 2):
        (log,) = (tmp_path / "log").glob(f"eval_online/simpler/serve_test/step_{step}/ta_4/42/*/eval.log")
        text = log.read_text()
        assert f"Model path: {root / f'step_{step}'}. Step: {step}" in text and "Number of episodes: 1" in text


class CountingClient:
    """A policy client's surface with no server: bounded random chunks."""

    def __init__(self):
        self.inferences, self.resets = 0, 0
        self.rng = np.random.default_rng(0)

    def infer(self, obs):
        self.inferences += 1
        chunk = self.rng.uniform(-0.02, 0.02, (4, 7))
        chunk[:, 6] = 1.0
        return chunk

    def reset(self):
        self.resets += 1
        return {"status": "reset"}

    def switch_model(self, path):
        raise AssertionError("no checkpoint sweep was asked")


def test_run_client_role_resolves_and_runs_the_ports_evaluator(tmp_path, monkeypatch):
    """--eval_cfg.role client builds the evaluator that simulator_path names
    (the port's SimplerEvaluator) from the experiment yaml and runs it: here
    on the fake env (the default env factory monkeypatched) with an injected
    client."""
    from intact_tpu_torch import run as run_mod
    from intact_tpu_torch.envs.evaluators import fake
    from intact_tpu_torch.envs.evaluators import simpler as tsimpler

    monkeypatch.setenv("VLA_LOG_DIR", str(tmp_path))
    monkeypatch.setitem(sys.modules, "imageio", None)  # the .npz videos: imageio without ffmpeg writes no mp4
    monkeypatch.setattr(tsimpler, "_default_env_factory", fake.fake_env_factory)
    monkeypatch.setattr(tsimpler, "_default_image_getter", fake.fake_image_getter)
    client = CountingClient()
    monkeypatch.setattr(tsimpler.SimplerEvaluator, "__init__",
                        functools.partialmethod(tsimpler.SimplerEvaluator.__init__, client=client))
    argv = ["--config_path", str(REPO / "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"),
            "--eval_cfg.role", "client", "--eval_cfg.task_list", '["widowx_spoon_on_towel"]',
            "--eval_cfg.n_eval_episode", "2", "--eval_cfg.pretrained_model_gradient_step_cnt", "null"]
    cfg, _ = run_mod.build_config(argv)
    assert cfg.eval_cfg.simulator_path == "intact_tpu_torch.envs.evaluators.simpler.SimplerEvaluator"
    assert run_bounded(lambda: run_mod.main(argv)) == 0
    assert client.inferences == 2 * 24 // 4 and client.resets == 2
    (log,) = tmp_path.glob("eval_online/simpler/pi0_finetune/step_0/ta_4/42/*/eval.log")
    assert "Task suite: widowx_spoon_on_towel" in log.read_text()
    assert len(list(log.parent.glob("widowx_spoon_on_towel/videos/video_*"))) == 2  # n_video 24, recording on
