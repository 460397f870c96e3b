"""The PyTorch port's serving stack on the CPU: the policy wrapper's fuse contract
(buckets, split fuses, sessions, fuse-key gate), the continuous-batching server
over loopback websockets with concurrent clients and a hot checkpoint swap, the
run CLI's server role, the checkpoint directory contract, and the config
sections against the reference's.

Every websocket wait is bounded: clients get a receive timeout, server threads
stop through their event loop and are joined with a time limit.
"""

import asyncio
import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from intact_tpu_torch.config.pipeline import EnvConfig, EvalConfig, TrainPipelineConfig

REPO = Path(__file__).resolve().parent.parent
STATS = str(REPO / "config/dataset/bridge_statistics.json")
WAIT_S = 60  # the longest any websocket wait may take


def make_cfg(port: int = 0, **eval_kw) -> TrainPipelineConfig:
    return TrainPipelineConfig(
        name="serve_test",
        model_cfg={"type": "pi0_tiny"},
        use_bf16=False,
        tokenizer_path="hash",
        eval_cfg=EvalConfig(
            simulator_name="simpler", env_adapter="BridgeSimplerAdapter", task_list=["widowx_carrot_on_plate"],
            n_eval_episode=2, n_video=0, recording=False, role="server", host="127.0.0.1", port=port,
            action_step=4, **eval_kw,
        ),
        env=EnvConfig(dataset_statistics_path=STATS, image_size=(28, 28)),
    )


OBS = {
    "observation.images.top": np.zeros((64, 64, 3), np.uint8),
    "observation.state": {"agent": {"eef_pos": np.array([0.1, 0.2, 0.3, 1.0, 0, 0, 0, 0.8])}},
    "task": "put the carrot on the plate",
}


# ---------------------------------------------------------------------------
# the fuse contract, with the device policy stubbed out
# ---------------------------------------------------------------------------

class _RecordingPolicy:
    """sample_action_chunk stub: records every device batch size and returns
    actions derived from the state, so the scatter is checkable."""

    def __init__(self):
        self.sizes = []

    def sample_action_chunk(self, batch):
        n = len(batch["task"])
        assert batch["image"].shape[0] == n and batch["state"].shape[0] == n
        self.sizes.append(n)
        return np.tile(batch["state"][:, :1, None], (1, 4, 7)).astype(np.float32)

    def reset(self):
        pass


class _IdentityAdapter:
    dataset_statistics = {"action": {"mean": [0.0] * 7}}

    def postprocess(self, actions):
        return np.asarray(actions)

    def reset(self):
        pass


class _BatchAdapter(_IdentityAdapter):
    def postprocess_batch(self, actions):
        return np.asarray(actions)


def fused_wrapper(max_batch=8):
    from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper, PolicySession
    from intact_tpu_torch.utils.monitor import setup_logger

    cfg = make_cfg(max_batch_size=max_batch)
    wrapper = Pi0PolicyWrapper.__new__(Pi0PolicyWrapper)
    wrapper.config = cfg
    wrapper.action_step = cfg.eval_cfg.action_step
    wrapper.policy = _RecordingPolicy()
    wrapper._default_session = None
    wrapper.env_adapter = _IdentityAdapter()
    wrapper.logger = setup_logger(True, name="test_serve_stack")
    return wrapper, PolicySession(wrapper, _IdentityAdapter())


def req(v, state_dim=7, img=28, rows=1):
    return {
        "image": np.zeros((rows, img, img, 3), np.float32),
        "state": np.stack([np.full(state_dim, v + i, np.float32) for i in range(rows)]),
        "task": ["t"] * rows,
    }


class TestBatchBucketing:
    def test_bucket_sizes(self):
        wrapper, _ = fused_wrapper(8)
        assert wrapper.bucket_sizes() == [1, 2, 4, 8]
        assert [wrapper.bucket_size(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
        wrapper6, _ = fused_wrapper(6)
        assert wrapper6.bucket_sizes() == [1, 2, 4, 6]
        assert wrapper6.bucket_size(5) == 6 and wrapper6.bucket_size(7) == 6
        assert wrapper.bucket_size(1000) == 8

    def test_infer_pads_to_bucket_and_scatters(self):
        wrapper, session = fused_wrapper(8)
        for n in (1, 2, 3, 5, 6, 7):
            out = wrapper.infer_batch([(req(float(i)), session) for i in range(n)])
            assert len(out) == n
            for i, a in enumerate(out):
                np.testing.assert_allclose(a, float(i))
        assert set(wrapper.policy.sizes) <= {1, 2, 4, 8}

    @pytest.mark.parametrize("case", ["fuse_wider_than_max", "vectorized_request_wider_than_max"])
    def test_oversized_fuses_split_device_calls(self, case):
        from intact_tpu_torch.serve.policy_wrapper import PolicySession

        wrapper, session = fused_wrapper(4)
        if case == "fuse_wider_than_max":
            out = wrapper.infer_batch([(req(float(i)), session) for i in range(7)])
            assert len(out) == 7
            for i, a in enumerate(out):
                np.testing.assert_allclose(a, float(i))
        else:
            out = wrapper.infer_batch([(req(0.0, rows=10), PolicySession(wrapper, _BatchAdapter()))])
            assert out[0].shape == (10, 4, 7)
            for i in range(10):
                np.testing.assert_allclose(out[0][i], float(i))
        assert set(wrapper.policy.sizes) <= {1, 2, 4}

    def test_multirow_requests_fuse_and_scatter(self):
        from intact_tpu_torch.serve.policy_wrapper import PolicySession

        wrapper, session = fused_wrapper(8)
        out = wrapper.infer_batch([(req(0.0), session),
                                   (req(10.0, rows=3), PolicySession(wrapper, _BatchAdapter()))])
        np.testing.assert_allclose(out[0], 0.0)
        assert out[1].shape == (3, 4, 7)
        for i in range(3):
            np.testing.assert_allclose(out[1][i], 10.0 + i)

    def test_prewarm_runs_every_bucket(self, monkeypatch):
        wrapper, _ = fused_wrapper(8)
        monkeypatch.setattr(type(wrapper), "new_session", lambda self: fused_wrapper(8)[1])
        monkeypatch.setattr(type(wrapper), "warmup_inputs", lambda self: req(0.0))
        wrapper.prewarm()
        assert wrapper.policy.sizes == [1, 2, 4, 8]

    def test_failing_postprocess_isolated_from_cobatched_clients(self):
        from intact_tpu_torch.serve.policy_wrapper import PolicySession

        wrapper, session = fused_wrapper(8)

        class _Failing(_IdentityAdapter):
            def postprocess(self, actions):
                raise RuntimeError("adapter broke")

        out = wrapper.infer_batch([(req(0.0), session), (req(5.0), PolicySession(wrapper, _Failing()))])
        np.testing.assert_allclose(out[0], 0.0)
        assert isinstance(out[1], RuntimeError)

    def test_mismatched_shapes_form_separate_fuse_groups(self):
        wrapper, session = fused_wrapper(8)
        odd, normal = req(1.0, state_dim=9), req(0.0)
        assert wrapper.fuse_key(odd) != wrapper.fuse_key(normal)
        reqs = [odd, normal, req(2.0)]
        groups = {}
        for r in reqs:
            groups.setdefault(wrapper.fuse_key(r), []).append(r)
        assert len(groups) == 2
        results = {}
        for group in groups.values():
            for r, res in zip(group, wrapper.infer_batch([(g, session) for g in group])):
                results[id(r)] = res
        for r, v in zip(reqs, (1.0, 0.0, 2.0)):
            np.testing.assert_allclose(results[id(r)], v)


@pytest.fixture(scope="module")
def tiny_wrapper():
    from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper

    return Pi0PolicyWrapper(make_cfg(max_batch_size=4, batch_timeout_ms=20), device="cpu")


class TestSessionIsolation:
    def test_fuse_key_rejects_task_row_mismatch(self, tiny_wrapper):
        good = {"image": np.zeros((2, 4, 4, 3), np.uint8), "state": np.zeros((2, 8), np.float32),
                "task": ["a", "b"]}
        assert tiny_wrapper.fuse_key(good)
        for bad_task in (["a"], []):
            with pytest.raises(ValueError, match="task"):
                tiny_wrapper.fuse_key({**good, "task": bad_task})

    def test_sessions_are_separate_and_reset_after_a_model_swap(self, tiny_wrapper):
        a, b = tiny_wrapper.new_session(), tiny_wrapper.new_session()
        assert a.adapter is not b.adapter and a.adapter.output_uint8  # the uint8 wire
        resets = []
        a.reset = lambda: resets.append("a")
        b.reset = lambda: resets.append("b")
        inputs = a.preprocess(OBS)
        assert inputs["image"].dtype == np.uint8 and inputs["image"].shape == (1, 28, 28, 3)
        tiny_wrapper.infer_batch([(inputs, a)])
        assert resets == []
        tiny_wrapper.model_generation += 1  # what every switch_model does
        try:
            out = tiny_wrapper.infer_batch([(inputs, a)])
            assert not isinstance(out[0], Exception) and out[0].shape == (4, 7)
            assert resets == ["a"] and a.model_generation == tiny_wrapper.model_generation
            assert b.model_generation != tiny_wrapper.model_generation  # b resets at its own next inference
        finally:
            tiny_wrapper.model_generation -= 1

    def test_uint8_wire_matches_float_path(self, tiny_wrapper):
        """select_action through the uint8 session wire equals feeding the
        policy the adapter's float frames (the same rng stream)."""
        from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper

        obs = {**OBS, "observation.images.top": np.random.default_rng(4).integers(0, 256, (128, 128, 3),
                                                                                  dtype=np.uint8)}
        a_u8 = Pi0PolicyWrapper(make_cfg(), device="cpu").select_action(obs)
        w_f = Pi0PolicyWrapper(make_cfg(), device="cpu")
        inputs = w_f.env_adapter.preprocess(obs)
        assert inputs["image"].dtype == np.float32
        chunk = w_f.policy.sample_action_chunk(inputs)
        a_f = w_f.env_adapter.postprocess(chunk[0, :w_f.action_step, :7])
        np.testing.assert_allclose(a_u8, a_f, rtol=1e-5, atol=1e-6)


class TestSwitchModelOrdering:
    def test_swap_splits_collected_batch_in_arrival_order(self):
        from intact_tpu_torch.serve.batching import BatchingPolicyServer, _Request

        class FakeWrapper:
            version = 0

            def fuse_key(self, inputs):
                return "k"

            def infer_batch(self, items):
                return [self.version] * len(items)

            def switch_model(self, path):
                assert path == "/new/model"
                self.version += 1

        server = BatchingPolicyServer(FakeWrapper(), make_cfg(), max_batch_size=8, batch_timeout_ms=50,
                                      prewarm=False)

        async def run():
            server._queue = asyncio.Queue()
            loop = asyncio.get_running_loop()
            fa, fs, fb = (loop.create_future() for _ in range(3))
            await server._queue.put(_Request({"x": 1}, None, fa))
            await server._queue.put(_Request(None, None, fs, switch_path="/new/model"))
            await server._queue.put(_Request({"x": 2}, None, fb))
            worker = asyncio.create_task(server._batch_worker())
            try:
                return await asyncio.wait_for(asyncio.gather(fa, fs, fb), timeout=WAIT_S)
            finally:
                worker.cancel()

        a, s, b = asyncio.run(run())
        assert (a, s, b) == (0, {"status": "model switched"}, 1)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_round_trip_partial_step_and_latest(self, tmp_path):
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.pi0 import model as tpi0
        from intact_tpu_torch.models.pi0.config import Pi0Config
        from intact_tpu_torch.train import checkpoint as ckpt

        cfg = Pi0Config.tiny()
        p3 = tpi0.init(cfg, seed=3, device="cpu")
        p5 = tpi0.init(cfg, seed=5, device="cpu")
        root = tmp_path / "checkpoint"
        path3 = ckpt.save_checkpoint(root, p3, step=3, aux={"name": "x"})
        ckpt.save_checkpoint(root, p5, step=5)
        assert json.loads((path3 / "auxiliary_data.json").read_text()) == {"cnt_update": 3, "name": "x"}
        (root / "step_9").mkdir()  # a crash mid-save: no commit marker
        (root / "step_9" / "params.pt").write_bytes(b"truncated")
        assert ckpt.list_steps(root) == [3, 5, 9] and ckpt.list_steps(root, committed_only=True) == [3, 5]
        latest = ckpt.restore_params(root, template=p5)  # the newest committed step
        for a, b in zip(cm.flatten_paths(latest).values(), cm.flatten_paths(p5).values()):
            assert torch.equal(a, b)
        step3 = cm.flatten_paths(ckpt.restore_params(path3))
        assert all(torch.equal(step3[k], v) for k, v in cm.flatten_paths(p3).items())
        with pytest.raises(FileExistsError, match="committed"):
            ckpt.save_checkpoint(root, p3, step=3)
        ckpt.save_checkpoint(root, p3, step=9)  # clears the partial leftovers
        assert ckpt.list_steps(root, committed_only=True) == [3, 5, 9]
        with pytest.raises(ValueError, match="does not fit"):
            ckpt.restore_params(path3, template={"x": torch.zeros(1)})
        (tmp_path / "only_partial" / "step_1").mkdir(parents=True)
        with pytest.raises(FileNotFoundError, match="uncommitted"):
            ckpt.restore_params(tmp_path / "only_partial")

    @pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
    def test_policy_load_and_from_checkpoint(self, tmp_path, quantize):
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.pi0 import model as tpi0
        from intact_tpu_torch.models.pi0.config import Pi0Config
        from intact_tpu_torch.models.pi0.policy import Pi0Policy
        from intact_tpu_torch.train import checkpoint as ckpt

        cfg = Pi0Config.tiny()
        saved = tpi0.init(cfg, seed=7, device="cpu")
        ckpt.save_checkpoint(tmp_path, saved, step=2)
        policy = Pi0Policy.from_checkpoint(str(tmp_path), cfg, seed=0, tokenizer_path="hash", use_bf16=False,
                                           device="cpu", quantize=quantize)
        want = cm.flatten_paths(cm.quantize_params(saved) if quantize else saved)
        got = cm.flatten_paths(policy.params)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        if quantize:
            assert got["vlm/blocks/mlp/up/kernel_q"].dtype == torch.int8

    def test_trainer_saves_at_save_model_freq(self, tmp_path, monkeypatch):
        from intact_tpu_torch.config import pipeline
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.pi0.config import Pi0Config
        from intact_tpu_torch.train import checkpoint as ckpt
        from intact_tpu_torch.train.trainer import Trainer

        monkeypatch.setattr(pipeline, "pi0_config_from_json", lambda d: Pi0Config.tiny())
        cfg = TrainPipelineConfig(
            name="ckpt_run", log_dir=tmp_path, fused_update=True, master_dtype="bfloat16", global_batch_size=2,
            per_device_batch_size=2, n_updates=2, save_model_freq=1, log_freq=1, tokenizer_path="hash",
            model_cfg={"type": "pi0"})
        trainer = Trainer(cfg, device="cpu")
        trainer.train()
        root = tmp_path / "ckpt_run" / "checkpoint"
        assert ckpt.list_steps(root, committed_only=True) == [1, 2]
        last = cm.flatten_paths(ckpt.restore_params(root))
        for k, v in cm.flatten_paths(trainer.state.params).items():
            assert torch.equal(last[k], v), k

    def test_trainer_saves_its_last_update(self, tmp_path, monkeypatch):
        """n_updates not a multiple of save_model_freq: the last update is
        saved too, after the periodic step_2, with the state it reached."""
        from intact_tpu_torch.config import pipeline
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.pi0.config import Pi0Config
        from intact_tpu_torch.train import checkpoint as ckpt
        from intact_tpu_torch.train.trainer import Trainer

        monkeypatch.setattr(pipeline, "pi0_config_from_json", lambda d: Pi0Config.tiny())
        cfg = TrainPipelineConfig(
            name="ckpt_run", log_dir=tmp_path, fused_update=True, master_dtype="bfloat16", global_batch_size=2,
            per_device_batch_size=2, n_updates=3, save_model_freq=2, log_freq=1, tokenizer_path="hash",
            model_cfg={"type": "pi0"})
        trainer = Trainer(cfg, device="cpu")
        trainer.train()
        root = tmp_path / "ckpt_run" / "checkpoint"
        assert ckpt.list_steps(root, committed_only=True) == [2, 3]
        last = cm.flatten_paths(ckpt.restore_params(root))
        for k, v in cm.flatten_paths(trainer.state.params).items():
            assert torch.equal(last[k], v), k


# ---------------------------------------------------------------------------
# the batching server and the run CLI over loopback websockets
# ---------------------------------------------------------------------------

class ServerThread:
    """Runs an async server's `run()`-like coroutine on its own event loop in
    a thread, bound to an ephemeral port, and stops it through that loop."""

    def __init__(self, serve_coro_factory):
        self.loop = asyncio.new_event_loop()
        self.port = None
        self._started = threading.Event()
        self._stop = None
        self._factory = serve_coro_factory
        self.thread = threading.Thread(target=self._main, daemon=True)
        self.thread.start()
        assert self._started.wait(WAIT_S), "server did not start"

    def _main(self):
        async def body():
            self._stop = asyncio.Event()
            await self._factory(self)

        try:
            self.loop.run_until_complete(body())
        finally:
            self.loop.close()

    def started(self, port):
        self.port = port
        self._started.set()

    def stop(self):
        self.loop.call_soon_threadsafe(self._stop.set)
        self.thread.join(timeout=WAIT_S)
        assert not self.thread.is_alive(), "server thread did not stop"


def serve_batching(server):
    """An ephemeral-port version of BatchingPolicyServer.run()."""

    async def factory(st):
        import websockets.asyncio.server

        server._queue = asyncio.Queue()
        worker = asyncio.create_task(server._batch_worker())
        try:
            async with websockets.asyncio.server.serve(server._handler, "127.0.0.1", 0, compression=None,
                                                       max_size=None) as ws:
                st.started(ws.sockets[0].getsockname()[1])
                await st._stop.wait()
        finally:
            worker.cancel()
            server._device_executor.shutdown(wait=False)

    return ServerThread(factory)


class Client:
    """The wire protocol's client with every wait bounded: connecting, the
    metadata push and each reply."""

    def __init__(self, port):
        import websockets.sync.client

        from intact_tpu_torch.protocol import msgpack_numpy

        self._msg = msgpack_numpy
        self._packer = msgpack_numpy.Packer()
        self._ws = websockets.sync.client.connect(f"ws://127.0.0.1:{port}", compression=None, max_size=None,
                                                  open_timeout=WAIT_S, ping_timeout=None)
        self.metadata = msgpack_numpy.unpackb(self._ws.recv(timeout=WAIT_S))

    def send(self, obs):
        self._ws.send(self._packer.pack(obs))
        resp = self._ws.recv(timeout=WAIT_S)
        if isinstance(resp, str):  # the server ships a traceback as text
            raise RuntimeError(resp)
        return self._msg.unpackb(resp)

    def close(self):
        try:
            self._ws.close_socket()  # abortive close: the server sees a dead peer at once
        except Exception:  # noqa: BLE001
            pass


class TestBatchingServerEndToEnd:
    def test_concurrent_clients_and_hot_swap(self, tiny_wrapper, tmp_path):
        from intact_tpu_torch.models import common as cm
        from intact_tpu_torch.models.pi0 import model as tpi0
        from intact_tpu_torch.serve.batching import BatchingPolicyServer
        from intact_tpu_torch.train import checkpoint as ckpt

        cfg = tiny_wrapper.config
        ckpt_dir = ckpt.save_checkpoint(tmp_path / "ckpt", tpi0.init(tiny_wrapper.model_cfg, seed=9, device="cpu"),
                                        step=7)
        server = BatchingPolicyServer(tiny_wrapper, cfg, metadata={"model": "pi0_tiny"}, max_batch_size=4,
                                      batch_timeout_ms=20, prewarm=False)
        st = serve_batching(server)
        errors, results = [], {}

        def run_client(i):
            c = None
            try:
                c = Client(st.port)
                assert c.metadata == {"model": "pi0_tiny"}
                for _ in range(3):
                    action = np.asarray(c.send(OBS))
                    assert action.shape == (4, 7) and np.isfinite(action).all()
                assert c.send({"reset": True}) == {"status": "reset"}
                results[i] = action
            except Exception as e:  # noqa: BLE001 — surfaced in the main thread
                errors.append(e)
            finally:
                if c is not None:
                    c.close()

        generation = tiny_wrapper.model_generation
        try:
            threads = [threading.Thread(target=run_client, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads) and not errors, errors
            assert len(results) == 3
            swapper = Client(st.port)
            try:
                assert swapper.send({"new_model_path": str(ckpt_dir)}) == {"status": "model switched"}
                after = np.asarray(swapper.send(OBS))
                assert after.shape == (4, 7) and np.isfinite(after).all()
                with pytest.raises(RuntimeError, match="FileNotFoundError"):
                    swapper.send({"new_model_path": str(tmp_path / "missing")})
            finally:
                swapper.close()
            assert tiny_wrapper.model_generation == generation + 1
            loaded = cm.flatten_paths(tiny_wrapper.policy.params)["vlm/blocks/attn/q/kernel"]
            assert torch.equal(loaded, cm.flatten_paths(ckpt.restore_params(ckpt_dir))["vlm/blocks/attn/q/kernel"])
        finally:
            st.stop()


def serve_role(argv, monkeypatch):
    """python -m intact_tpu_torch.run with `argv` (a server role), its server
    bound to an ephemeral port on a ServerThread -> (the served wrapper, the
    thread)."""
    from intact_tpu_torch import run as run_mod
    from intact_tpu_torch.protocol.websocket_policy_server import WebsocketPolicyServer
    from intact_tpu_torch.serve import server as server_mod

    captured = {}

    def fake_serve(policy, config):  # bind an ephemeral port, stop through the loop
        captured["policy"] = policy
        ws_server = WebsocketPolicyServer(policy, host="127.0.0.1", port=0, metadata={"model": config.model_type})

        async def factory(st):
            import websockets.asyncio.server

            async with websockets.asyncio.server.serve(ws_server._handler, "127.0.0.1", 0, compression=None,
                                                       max_size=None) as ws:
                st.started(ws.sockets[0].getsockname()[1])
                await st._stop.wait()

        captured["thread"] = ServerThread(factory)

    monkeypatch.setattr(server_mod, "serve", fake_serve)
    assert run_mod.main(argv) == 0
    return captured["policy"], captured["thread"]


def server_argv(model_type: str, quantize: bool) -> list[str]:
    return ["--config_path", str(REPO / "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"),
            "--eval_cfg.role", "server", "--eval_cfg.quantize_int8", str(quantize).lower(),
            "--eval_cfg.pretrained_model_path", "null", "--eval_cfg.max_batch_size", "1",
            "--model_cfg.type", model_type, "--tokenizer_path", "hash", "--use_bf16", "false",
            "--env.image_size", "[28, 28]", "--env.dataset_statistics_path", STATS, "--device", "cpu"]


class TestRunCLIServerRole:
    def test_server_dispatch_serves_int8_over_websocket(self, tmp_path, monkeypatch):
        """python -m intact_tpu_torch.run --eval_cfg.role server, end to end:
        config -> wrapper (int8) -> per-request websocket server -> client."""
        from intact_tpu_torch import run as run_mod

        argv = server_argv("pi0_tiny", quantize=True)
        cfg, device = run_mod.build_config(argv)
        assert cfg.eval_cfg.quantize_int8 and device == "cpu" and cfg.wandb.project == "vla_benchmark"
        policy, st = serve_role(argv, monkeypatch)
        try:
            assert "kernel_q" in policy.policy.params["vlm"]["blocks"]["mlp"]["up"]
            c = Client(st.port)
            try:
                action = np.asarray(c.send(OBS))
                assert action.shape == (4, 7) and np.isfinite(action).all()
                assert c.send({"reset": True}) == {"status": "reset"}
            finally:
                c.close()
        finally:
            st.stop()

    @pytest.mark.parametrize("model_type,quantize", [("mvla_tiny", True), ("mmmvla_tiny", False)])
    def test_server_role_serves_mvla_over_websocket(self, monkeypatch, model_type, quantize):
        """The server role for the MVLA types: the registry's wrapper serves
        the mvla model module (self/cross pairs int8 for mvla_tiny, the joint
        expert in fp32 for mmmvla_tiny); a client's action equals the model's
        sample_actions on the same inputs and noise draw, through the
        adapter's postprocess."""
        from intact_tpu_torch.models.mvla import model as tmvla
        from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper

        wrapper, st = serve_role(server_argv(model_type, quantize), monkeypatch)
        try:
            assert type(wrapper) is Pi0PolicyWrapper and wrapper.policy.model is tmvla
            mc, params = wrapper.model_cfg, wrapper.policy.params
            assert mc.alternate_pattern == ("joint" if model_type.startswith("mmmvla") else "self_cross")
            if quantize:
                assert params["expert"]["pairs"]["cross"]["attn"]["k"]["kernel_q"].dtype == torch.int8
                assert params["connector"]["blocks"]["mlp"]["up"]["kernel_q"].dtype == torch.int8
            else:
                assert "kernel" in params["expert"]["blocks"]["attn"]["q"]
            c = Client(st.port)
            try:
                assert c.metadata == {"model": model_type}
                action = np.asarray(c.send(OBS))
                assert c.send({"reset": True}) == {"status": "reset"}
            finally:
                c.close()
            assert action.shape == (4, 7) and np.isfinite(action).all()
            inputs = wrapper.new_session().preprocess(OBS)
            gen = torch.Generator().manual_seed(wrapper.config.seed)  # the policy's first draw
            chunk = tmvla.sample_actions(params, gen, *wrapper.policy.device_inputs(inputs), mc, wrapper.policy.policy)
            want = wrapper.env_adapter.postprocess(chunk[0, :wrapper.action_step, :7].numpy())
            np.testing.assert_array_equal(action, want)
        finally:
            st.stop()

    def test_client_role_and_other_families_raise(self, monkeypatch):
        from intact_tpu_torch import run as run_mod
        from intact_tpu_torch.protocol import websocket_policy_client
        from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

        def no_server(host, port):  # the client role reaches the evaluator's websocket client
            raise ConnectionRefusedError(f"no policy server at {host}:{port}")

        monkeypatch.setattr(websocket_policy_client, "WebsocketPolicyClient", no_server)
        with pytest.raises(ConnectionRefusedError, match="no policy server at 0.0.0.0:8000"):
            run_mod.main(["--config_path", str(REPO / "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"),
                          "--eval_cfg.role", "client", "--device", "cpu"])
        cfg = make_cfg()
        cfg.model_cfg = {"type": "spatialvla"}  # the HF-scaffold wrapper is not ported
        with pytest.raises(NotImplementedError, match="the other model families"):
            make_policy_wrapper(cfg, device="cpu")

    def test_wrapper_raises_without_cuda_unless_given_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid here")
        from intact_tpu_torch.serve.policy_wrapper import Pi0PolicyWrapper

        with pytest.raises(RuntimeError, match="no CUDA device"):
            Pi0PolicyWrapper(make_cfg())


# ---------------------------------------------------------------------------
# config sections
# ---------------------------------------------------------------------------

def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["EvalConfig", "EnvConfig", "WandBConfig"])
def test_config_sections_match_reference(name):
    from intact_tpu.config import pipeline as jpipe
    from intact_tpu_torch.config import pipeline as tpipe

    assert _fields(getattr(tpipe, name)) == _fields(getattr(jpipe, name))


def test_eval_paths_point_into_the_port():
    from intact_tpu.config.pipeline import EvalConfig as JEval
    from intact_tpu.config.pipeline import TrainPipelineConfig as JCfg

    ours, ref = make_cfg(), JCfg(eval_cfg=JEval())
    assert ours.eval_cfg.env_adapter_path == "intact_tpu_torch.envs.adapters.simpler.BridgeSimplerAdapter"
    assert ref.eval_cfg.env_adapter_path == "intact_tpu.envs.adapters.simpler.BridgeSimplerAdapter"
    assert ref.eval_cfg.simulator_path == "intact_tpu.envs.evaluators.simpler.SimplerEvaluator"
    assert ours.eval_cfg.simulator_path == "intact_tpu_torch.envs.evaluators.simpler.SimplerEvaluator"
    for sim, adapter, evaluator, kw in [("simplerMS3", "BatchBridgeSimplerAdapter", "SimplerMS3Evaluator",
                                         {"n_parallel_eval": 4}), ("libero", "LiberoAdapter", "LiberoEvaluator", {})]:
        ours = TrainPipelineConfig(eval_cfg=EvalConfig(simulator_name=sim, env_adapter=adapter, **kw))
        ref = JCfg(eval_cfg=JEval(simulator_name=sim, env_adapter=adapter, **kw))
        assert ours.eval_cfg.simulator_path == f"intact_tpu_torch.envs.evaluators.{sim}.{evaluator}"
        assert ref.eval_cfg.simulator_path == f"intact_tpu.envs.evaluators.{sim}.{evaluator}"
        assert ours.eval_cfg.env_adapter_path == f"intact_tpu_torch.envs.adapters.{sim}.{adapter}"
    with pytest.raises(ValueError, match="simplerMS3"):
        make_cfg(n_parallel_eval=4)
