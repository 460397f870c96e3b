"""Serving over several ranks: spawned gloo groups on the CPU (tests/test_torch_serve_ranks_child.py).

Two groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, and each group is joined within JOIN_TIMEOUT or the
test fails (its processes are killed): nothing here can hang the run. The
websocket clients of the server-role case run in daemon threads joined
within 60 s.

  * two ranks: Pi0 fp32 at data 2 and int8 at fsdp 2 on the JAX package's
    weights, Pi0 at data 2 on the noise rank 0 draws, MVLA at fsdp 2, the
    native SpatialVLA and Magma wrappers built from a step checkpoint at
    fsdp 2, the server role's wrapper switching to a checkpoint at fsdp 2,
    Octo (whole on rank 0), and run.py's server role at fsdp 2 answering
    loopback websocket clients through the batching server;
  * four ranks: Pi0 fp32 at (data 2, fsdp 2) on batches of 8, 1 and 3, and
    Pi0FAST (fp32 and int8) and int8 SpatialVLA and Magma at (2, 2).

Each is held to the port on one rank (rtol 1e-5 for sampled actions, equal
tokens), and the (2, 2) Pi0 also to `jax.jit` of the JAX package's Pi0Policy
on a (2, 2, 1) mesh of virtual devices (tests/test_parallel_train.py's
tolerance, 2e-4), all on the same noise. Without a process group nothing is
sharded and nothing changes.
"""

import logging
import socket
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_serve_ranks_child as child
from intact_tpu.models import common as jcm
from intact_tpu.models.magma import model as jmagma
from intact_tpu.models.magma.config import MagmaConfig as JMagmaConfig
from intact_tpu.models.mvla import model as jmvla
from intact_tpu.models.mvla.config import MVLAConfig as JMVLAConfig
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.models.pi0.policy import Pi0Policy as JPi0Policy
from intact_tpu.models.spatialvla import model as jsvla
from intact_tpu.models.spatialvla.config import SpatialVLAConfig as JSVLAConfig
from intact_tpu.parallel import MeshConfig as JMeshConfig
from intact_tpu.parallel import make_mesh as j_make_mesh
from intact_tpu.parallel import sharding as jsharding
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models.magma import model as tmagma
from intact_tpu_torch.models.magma.config import MagmaConfig
from intact_tpu_torch.models.mvla import model as tmvla
from intact_tpu_torch.models.mvla.config import MVLAConfig
from intact_tpu_torch.models.pi0 import model as tpi0
from intact_tpu_torch.models.pi0.config import Pi0Config
from intact_tpu_torch.models.pi0.policy import Pi0Policy
from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
from intact_tpu_torch.models.spatialvla import model as tsvla
from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig
from intact_tpu_torch.parallel import sharding
from intact_tpu_torch.parallel.mesh import Mesh, single_rank_mesh

REPO = Path(__file__).resolve().parent.parent
JOIN_TIMEOUT = 120.0  # seconds per group, then the test fails
ACTIONS_RTOL = 1e-5  # the ranks against the port on one rank
JAX_TOL = 2e-4  # against the JAX package's sharded Pi0Policy (tests/test_parallel_train.py)
ROWS = 8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, workdir: Path):
    return mp.start_processes(fn, args=(world, free_port(), str(workdir)), nprocs=world, join=False,
                              start_method="spawn")


def join(ctx, deadline: float, name: str) -> None:
    """Wait for a group until the deadline; a rank's exception re-raises
    here, and a group still running then is killed and fails the test."""
    while not ctx.join(timeout=max(0.5, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {name} group did not finish within {JOIN_TIMEOUT:.0f} s")


def policy_batch(size: int, rng: np.random.Generator, b: int = ROWS) -> dict:
    return {"image": rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
            "state": rng.normal(size=(b, 7)).astype(np.float32),
            "task": [f"put object {i} on the plate" for i in range(b)]}


def wire_obs(size: int, seed: int) -> dict:
    return {"observation.images.top": np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8),
            "observation.state": {"agent": {"eef_pos": np.array([0.1, 0.2, 0.3, 1.0, 0, 0, 0, 0.8])}},
            "task": f"put the carrot on plate {seed}"}


def one_rank(policy: Pi0Policy, batch: dict, noise: torch.Tensor) -> np.ndarray:
    """The policy on one rank, every row, on the given noise."""
    return policy._sample_rows(*(policy._put(x) for x in policy.prepare_inputs(batch)), noise=noise).numpy()


def padded(batch: dict, world: int) -> dict:
    return {k: (v + [v[-1]] * (-len(v) % world)) if isinstance(v, list) else sharding.pad_rows([v], world)[0]
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Write the ranks' inputs, spawn both groups, compute the one-rank and
    JAX references meanwhile, join, and hand everything to the tests."""
    from intact_tpu_torch.train import checkpoint as ckpt

    workdir = tmp_path_factory.mktemp("serve_ranks")
    rng = np.random.default_rng(3)
    jcfg, cfg = JPi0Config.tiny(), Pi0Config.tiny()
    jmesh = j_make_mesh(JMeshConfig(data=2, fsdp=2, tensor=1), devices=jax.devices()[:4])
    jpolicy = JPi0Policy(jcfg, seed=0, use_bf16=False, mesh=jmesh, tokenizer_path="hash")
    key = jax.random.split(jax.random.key(0))[1]  # the JAX policy's first draw
    pi0_noise = np.array(jpi0.sample_noise(key, (ROWS, jcfg.chunk_size, jcfg.max_action_dim)))
    pi0_params = convert.from_jax_params(jax.tree.map(np.asarray, jpolicy.params), cfg, device="cpu")
    jax_ckpt = ckpt.save_checkpoint(workdir / "jax_ckpt", pi0_params, step=1)  # the wrappers load it
    pi0_batch = policy_batch(cfg.vision.image_size, rng)
    mcfg = MVLAConfig.tiny()
    mvla_batch = policy_batch(mcfg.vision.image_size, rng, 5)
    mvla_noise = torch.from_numpy(rng.standard_normal((6, mcfg.chunk_size, mcfg.max_action_dim), dtype=np.float32))
    ckpt_root = workdir / "ckpt"
    ckpt_path = ckpt.save_checkpoint(ckpt_root, tpi0.init(cfg, seed=1, device="cpu"), step=1)
    svla_cfg, magma_cfg = SpatialVLAConfig.tiny(), MagmaConfig.tiny()
    native_ckpt = {name: str(ckpt.save_checkpoint(workdir / name, mod.init(c, seed=1, device="cpu"), step=1))
                   for name, mod, c in (("spatialvla_native_tiny", tsvla, svla_cfg),
                                        ("magma_native_tiny", tmagma, magma_cfg))}
    s, m = svla_cfg.vision.image_size, magma_cfg.image_size
    tasks = ["put the spoon on the towel", "stack the blocks", "open the drawer"]
    inputs = {
        "jax_ckpt": str(jax_ckpt), "pi0_noise": torch.from_numpy(pi0_noise), "pi0_batch": pi0_batch,
        "draw_batch": policy_batch(cfg.vision.image_size, rng, 5),
        "pi0fast_batch": policy_batch(Pi0FASTConfig.tiny().vision.image_size, rng, 3),
        "mvla_batch": mvla_batch, "mvla_noise": mvla_noise, "ckpt": str(ckpt_path), "native_ckpt": native_ckpt,
        "octo_obs": [wire_obs(32, i) for i in range(2)], "server_obs": [wire_obs(child.IMAGE, i) for i in range(3)],
        "spatialvla_native_tiny": (rng.integers(0, 256, (3, s, s, 3), dtype=np.uint8),
                                   np.asarray(tsvla.flat_depth(3, svla_cfg), np.float32), tasks),
        "magma_native_tiny": (rng.integers(0, 256, (3, m, m, 3), dtype=np.uint8), tasks),
    }
    torch.save(inputs, workdir / "inputs.pt")
    deadline = time.monotonic() + JOIN_TIMEOUT
    contexts = {"pair": spawn(child.pair, 2, workdir), "quad": spawn(child.quad, 4, workdir)}
    try:
        refs = references(jpolicy, inputs)
    except BaseException:
        for ctx in contexts.values():
            for p in ctx.processes:
                p.kill()
        raise
    for name, ctx in contexts.items():
        join(ctx, deadline, name)
    return {"refs": refs, "inputs": inputs,
            "pair": [torch.load(workdir / f"pair_rank{r}.pt", weights_only=False) for r in range(2)],
            "quad": [torch.load(workdir / f"quad_rank{r}.pt", weights_only=False) for r in range(4)]}


def references(jpolicy, inputs: dict) -> dict:
    """The port on one rank (the same wrappers without a group) on the same
    weights, inputs and noise, and the JAX package's Pi0Policy jitted on its
    (2, 2, 1) mesh."""
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    out = {"jax_2x2": np.asarray(jpolicy.sample_action_chunk(dict(inputs["pi0_batch"])))}
    noise, batch = inputs["pi0_noise"], inputs["pi0_batch"]
    fp = child.pi0_wrapper(inputs, None).policy
    out["pi0"] = one_rank(fp, batch, noise)
    for n in (1, 3):  # the ranks' padded batch of 4, the last row repeated
        rows = padded({k: v[:n] for k, v in batch.items()}, 4)
        out[f"pi0_{n}"] = one_rank(fp, rows, noise[:4])[:n]
    out["int8"] = one_rank(child.pi0_wrapper(inputs, None, quantize=True).policy, batch, noise)
    drawn = child.pi0_wrapper(inputs, None).policy  # its generator's first draw, for the padded batch of 6
    out["draw"] = one_rank(drawn, padded(inputs["draw_batch"], 2), None)[:5]
    mvla = child.pi0_wrapper(inputs, None, model_type="mvla_tiny").policy
    out["mvla"] = one_rank(mvla, padded(inputs["mvla_batch"], 2), inputs["mvla_noise"])[:5]
    for name, quantize in (("pi0fast_tiny", False), ("pi0fast_tiny_int8", True)):
        fast = child.pi0_wrapper(inputs, None, quantize, model_type="pi0fast_tiny")
        out[name] = fast.sample_action_chunk(inputs["pi0fast_batch"])
    switched = make_policy_wrapper(child.server_config("pi0_tiny"), device="cpu")
    switched.switch_model(inputs["ckpt"])
    out["switch"] = one_rank(switched.policy, batch, noise)
    octo = make_policy_wrapper(child.server_config("octo_tiny", **{
        "eval_cfg.env_adapter": "OctoBridgeSimplerAdapter", "env.image_size": "[32, 32]"}), device="cpu")
    out["octo"] = [octo.infer_batch([(octo.session.preprocess(obs), octo.session)])[0] for obs in inputs["octo_obs"]]
    for name, op in child.NATIVE.items():
        wrapper = make_policy_wrapper(child.server_config(name, **{"eval_cfg.quantize_int8": "true"}), device="cpu")
        out[name] = getattr(wrapper, op)(*inputs[name])
        wrapper = make_policy_wrapper(child.server_config(name, **{
            "eval_cfg.quantize_int8": "true", "eval_cfg.pretrained_model_path": inputs["native_ckpt"][name]}),
            device="cpu")
        out[f"{name}_ckpt"] = getattr(wrapper, op)(*inputs[name])
    return out


def assert_sharded_halves(sharded: dict, parts: int, what: str) -> None:
    """Some leaves are split, each a 1/parts slice along one dimension."""
    assert sharded, f"{what}: no leaf is sharded"
    for k, (local, whole) in sharded.items():
        diff = [i for i, (a, b) in enumerate(zip(local, whole)) if a != b]
        assert len(diff) == 1 and local[diff[0]] * parts == whole[diff[0]], (what, k, local, whole)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, data: int, fsdp: int):
        self.shape = {"data": data, "fsdp": fsdp, "tensor": 1}


def port_spec_of_jax(path: str, jax_spec) -> tuple:
    """JAX's spec with the tensor axis dropped, the last two entries swapped for kernel_q."""
    spec = tuple(None if a == "tensor" else a for a in jax_spec)
    return spec[:-2] + (spec[-1], spec[-2]) if path.endswith("kernel_q") and len(spec) >= 2 else spec


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2x1", "2x2x1"])
@pytest.mark.parametrize("family", ["pi0", "pi0_int8", "mvla", "mvla_int8", "spatialvla", "spatialvla_int8",
                                    "magma", "magma_int8"])
def test_spec_for_path_is_the_jax_packages(family, mesh):
    """Every leaf of the tiny tree: the port's spec on its own shape equals
    the JAX package's on its shape, tensor dropped, kernel_q transposed."""
    name, _, q = family.partition("_")
    jmod, jcfg, tmod, tcfg = {
        "pi0": (jpi0, JPi0Config.tiny(), tpi0, Pi0Config.tiny()),
        "mvla": (jmvla, JMVLAConfig.tiny(), tmvla, MVLAConfig.tiny()),
        "spatialvla": (jsvla, JSVLAConfig.tiny(), tsvla, SpatialVLAConfig.tiny()),
        "magma": (jmagma, JMagmaConfig.tiny(), tmagma, MagmaConfig.tiny()),
    }[name]
    jtree = jax.eval_shape(lambda k: jmod.init(k, jcfg), jax.random.key(0))
    ttree = tmod.init(tcfg, device="meta")
    if q:
        jtree = jax.eval_shape(jcm.quantize_params, jtree)
        ttree = tcm.quantize_params(ttree)
    jflat, tflat = tcm.flatten_paths(jtree), tcm.flatten_paths(ttree)
    assert set(jflat) == set(tflat)
    fake = FakeMesh(*mesh)
    tmesh = Mesh(mesh[0], mesh[1], 1, 0, {"data": None, "fsdp": None, "world": None})
    specs = sharding.param_specs(ttree, tmesh)
    split = 0
    for path, leaf in tflat.items():
        want = port_spec_of_jax(path, tuple(jsharding.spec_for_path(path, jflat[path].shape, fake)))
        got = sharding.spec_for_path(path, leaf.shape, tmesh)
        assert got == want, (path, got, want)
        assert tcm.flatten_paths(specs)[path] == got
        split += "fsdp" in got
    assert split > 0
    if q:
        assert any(p.endswith("kernel_q") and "fsdp" in tcm.flatten_paths(specs)[p] for p in tflat)


def test_without_a_group_nothing_is_sharded():
    """A mesh without a process group (one process, no launcher): no serving
    group, plain tensors, the actions of the wrapper without a mesh bit for
    bit, and the policy's own sample_action_chunk too."""
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = Pi0Config.tiny()
    batch = policy_batch(cfg.vision.image_size, np.random.default_rng(0), 3)
    plain = make_policy_wrapper(child.server_config("pi0_tiny"), device="cpu")
    meshed = make_policy_wrapper(child.server_config("pi0_tiny"), device="cpu", mesh=single_rank_mesh())
    assert meshed.group is None and all(isinstance(x, torch.Tensor) for x in tcm.tree_leaves(meshed.policy.params))
    np.testing.assert_array_equal(meshed.sample_action_chunk(batch), plain.sample_action_chunk(batch))
    policy = Pi0Policy(cfg, seed=0, use_bf16=False, tokenizer_path="hash", device="cpu", mesh=single_rank_mesh())
    bare = Pi0Policy(cfg, seed=0, use_bf16=False, tokenizer_path="hash", device="cpu")
    np.testing.assert_array_equal(policy.sample_action_chunk(batch), bare.sample_action_chunk(batch))


def test_effective_fused_size_and_prewarm_dedupe():
    """Over data 2 x fsdp 2 the buckets 1, 2, 4 run at 4 and 8 at 8: prewarm
    runs each device batch once."""
    from intact_tpu_torch.serve.policy_wrapper import BasePolicyWrapper

    class Stub(BasePolicyWrapper):
        def __init__(self):
            self.config = child.server_config("pi0_tiny", **{"eval_cfg.max_batch_size": 8})
            self.mesh = Mesh(2, 2, 1, 0, {"data": None, "fsdp": None, "world": None})
            self.calls = []
            self.logger = logging.getLogger("stub")

        def new_session(self):
            return None

        def warmup_inputs(self):
            return {}

        def infer_batch(self, items):
            self.calls.append(len(items))
            return [np.zeros(1)] * len(items)

    w = Stub()
    assert [w.effective_fused_size(n) for n in (1, 2, 3, 4, 5, 8)] == [4, 4, 4, 4, 8, 8]
    w.prewarm()
    assert w.calls == [1, 8]


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_pi0_at_data_2_matches_one_rank(groups):
    ranks = [r["pi0"]["pi0_2x1"] for r in groups["pair"]]
    assert not ranks[0]["sharded"] and ranks[1]["actions"] is None  # fsdp 1: whole params, rank 0 answers
    np.testing.assert_allclose(ranks[0]["actions"][0], groups["refs"]["pi0"], rtol=ACTIONS_RTOL, atol=1e-6)
    # per inference: a header and the 5 arrays and the noise broadcast, one gather; then the stop's header
    for r in ranks:
        assert r["collectives"] == {"broadcast": 8, "all_gather": 1, "bucket_all_gather": 0}


def test_int8_pi0_at_fsdp_2_matches_one_rank(groups):
    ranks = [r["pi0"]["int8_1x2"] for r in groups["pair"]]
    for r in ranks:
        assert_sharded_halves(r["sharded"], 2, "int8")
        assert any(k.endswith("kernel_q") for k in r["sharded"])
        # the actions' gather, and one bucket gather per layer that uses split leaves
        assert r["collectives"] == ranks[0]["collectives"] and r["collectives"]["all_gather"] == 1
        assert r["collectives"]["bucket_all_gather"] > 1
    np.testing.assert_allclose(ranks[0]["actions"][0], groups["refs"]["int8"], rtol=ACTIONS_RTOL, atol=1e-6)


def test_pi0_draws_the_padded_batchs_noise_on_rank_0(groups):
    """At data 2 with the policy's own draw: rank 0's generator draws the
    noise of the padded batch (5 rows -> 6), as one rank with the same seed
    draws it for that batch, so the two agree."""
    got = groups["pair"][0]["pi0"]["pi0_draw"]["actions"][0]
    assert got.shape == groups["refs"]["draw"].shape and got.shape[0] == 5
    np.testing.assert_allclose(got, groups["refs"]["draw"], rtol=ACTIONS_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", list(child.NATIVE))
def test_native_wrappers_build_from_a_checkpoint_at_fsdp_2(groups, name):
    """Built with eval_cfg.pretrained_model_path over 2 ranks, each rank
    restores its own share of the step checkpoint; the tokens equal one rank's."""
    ranks = [r["native"][name] for r in groups["pair"]]
    for r in ranks:
        assert_sharded_halves(r["sharded"], 2, name)
        assert r["generation"] == 1
    assert ranks[1]["ids"] is None
    np.testing.assert_array_equal(ranks[0]["ids"], groups["refs"][f"{name}_ckpt"])
    assert not np.array_equal(groups["refs"][f"{name}_ckpt"], groups["refs"][name])  # the checkpoint's, not the seed's


def test_mvla_at_fsdp_2_matches_one_rank(groups):
    ranks = [r["pi0"]["mvla_1x2"] for r in groups["pair"]]
    assert any("pairs" in k for k in ranks[0]["sharded"])
    for r in ranks:
        assert_sharded_halves(r["sharded"], 2, "mvla")
    np.testing.assert_allclose(ranks[0]["actions"][0], groups["refs"]["mvla"], rtol=ACTIONS_RTOL, atol=1e-6)


def test_switch_model_across_ranks(groups):
    """Rank 0 sends the path; every rank restores its own share of the
    checkpoint and bumps its model generation."""
    ranks = [r["switch"] for r in groups["pair"]]
    for r in ranks:
        assert r["generation"] == 1
        assert_sharded_halves(r["sharded"], 2, "switch")
    np.testing.assert_allclose(ranks[0]["actions"], groups["refs"]["switch"], rtol=ACTIONS_RTOL, atol=1e-6)


def test_octo_runs_whole_on_rank_0(groups):
    ranks = [r["octo"] for r in groups["pair"]]
    assert ranks[0]["type"] == "OctoPolicyWrapper" and ranks[1] == {}  # the follower builds nothing
    for got, want in zip(ranks[0]["answers"], groups["refs"]["octo"]):
        np.testing.assert_array_equal(got, want)


def test_server_role_on_two_ranks_over_websockets(groups):
    """run.py's server role at fsdp 2, int8: the batching server on rank 0
    answers three loopback clients (fused, padded to the world), rank 1 runs
    its rows of every call and ends with the server."""
    ranks = [r["server"] for r in groups["pair"]]
    lead = ranks[0]
    assert lead["clients_alive"] == 0 and lead["metadata"]["model"] == "pi0_tiny"
    for a in lead["answers"]:
        assert a is not None and a.shape == (4, 7) and np.isfinite(a).all()
    assert lead["resets"] == [{"status": "reset"}] * 3
    assert ranks[1]["collectives"] == lead["collectives"] and lead["collectives"]["broadcast"] > 0


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def test_pi0_at_2x2_matches_one_rank_and_jax(groups):
    ranks = [r["pi0_2x2"] for r in groups["quad"]]
    for r in ranks:
        assert_sharded_halves(r["sharded"], 2, "pi0 2x2")
    got = ranks[0]["actions"][0]
    np.testing.assert_allclose(got, groups["refs"]["pi0"], rtol=ACTIONS_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, groups["refs"]["jax_2x2"], rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_odd_batches_at_world_4_slice_the_padding_off(groups, n):
    got = dict(zip((8, 1, 3), groups["quad"][0]["pi0_2x2"]["actions"]))[n]
    want = groups["refs"]["pi0" if n == 8 else f"pi0_{n}"]
    assert got.shape == (n, Pi0Config.tiny().chunk_size, Pi0Config.tiny().max_action_dim)
    np.testing.assert_allclose(got, want, rtol=ACTIONS_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["spatialvla_native_tiny", "magma_native_tiny", "pi0fast_tiny", "pi0fast_tiny_int8"])
def test_greedy_families_at_2x2_equal_one_rank(groups, name):
    ranks = [r[name] for r in groups["quad"]]
    for r in ranks:
        assert_sharded_halves(r["sharded"], 2, name)
    if name.startswith("pi0fast"):  # the tied head's rows, gathered in _logits
        assert "vlm_embed/embedding" in ranks[0]["sharded"]
        got = ranks[0]["actions"][0]
    else:
        assert any(k.endswith(("embedding_q", "lm_head/kernel_q")) for k in ranks[0]["sharded"])
        got = ranks[0]["ids"]
    np.testing.assert_array_equal(got, groups["refs"][name])


# ---------------------------------------------------------------------------
# the server role's refusals, the HF-scaffold wrappers, the import walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override, error, match", [
    (["--mesh.tensor", "2", "--model_cfg.type", "mvla_tiny"], NotImplementedError, "tensor axis .* serving mvla"),
    (["--mesh.fsdp", "2"], ValueError, "not divisible by fsdp"),
], ids=["tensor", "unfilled"])
def test_server_role_refuses_tensor_and_an_unfilled_mesh(override, error, match):
    from intact_tpu_torch import run

    argv = ["--config_path", str(child.EV_CONFIG), "--eval_cfg.role", "server", "--model_cfg.type", "pi0_tiny",
            "--eval_cfg.pretrained_model_path", "null", "--tokenizer_path", "hash", "--device", "cpu", *override]
    with pytest.raises(error, match=match):
        run.main(argv)


@pytest.mark.parametrize("model_type, cls", [("spatialvla", "SpatialVLAPolicyWrapper"),
                                              ("magma", "MagmaPolicyWrapper")])
def test_hf_scaffold_types_raise_without_an_asset(model_type, cls, tmp_path):
    """The registry maps the HF-scaffold types to their wrappers, which serve
    on rank 0 alone and raise without the upstream snapshot."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.serve import policy_wrapper as pw

    assert registry.get(model_type)["wrapper"] == f"intact_tpu_torch.serve.policy_wrapper.{cls}"
    assert not getattr(pw, cls).serves_on_ranks
    cfg = child.server_config(model_type, **{"eval_cfg.pretrained_model_path": str(tmp_path / "missing")})
    with pytest.raises(RuntimeError, match="needs the upstream HF checkpoint"):
        pw.make_policy_wrapper(cfg, device="cpu")
    if not torch.cuda.is_available():  # an entry point of the port: CUDA unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pw.make_policy_wrapper(cfg)


def test_port_walk_covers_the_serving_group():
    """tests/test_torch_port.py's import walks cover the serving group, and
    the ranks' module imports no JAX."""
    import test_torch_port as port

    names = {str(p.relative_to(REPO)) for p in port.PORT_FILES}
    assert "intact_tpu_torch/serve/group.py" in names and "intact_tpu_torch/parallel/sharding.py" in names
    mods = port.imported_modules(REPO / "tests/test_torch_serve_ranks_child.py")
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "intact_tpu")}
