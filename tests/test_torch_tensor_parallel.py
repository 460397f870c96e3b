"""The tensor axis (Megatron-style, Pi0): spawned gloo groups on the CPU (tests/test_torch_tensor_parallel_ranks.py).

Three groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, and each group is joined within JOIN_TIMEOUT or the
test fails (its processes are killed): nothing here can hang the run.

  * two ranks, mesh (1, 1, 2): Pi0's standard joint step (8-bit AdamW with
    the tiny leaves quantized, an active clip, accumulation 2) and its
    expert-only step on the int8-frozen prefix (AdamW), Pi0Policy in fp32
    and in int8, 8-bit moments of a last-dimension tensor slice;
  * four ranks: the joint step at (1, 2, 2) and (2, 1, 2), the expert-only
    step at (2, 1, 2), both steps and the policy at (1, 1, 4) on a tiny
    variant with 4 query heads, int8 serving at (1, 2, 2), 8-bit moments of
    a tensor slice split further over fsdp, and the joint recipe's Trainer
    at (1, 2, 2) saving a checkpoint that resumes on one rank;
  * eight ranks, mesh (2, 2, 2), as tests/test_parallel_train.py's: the two
    steps and Pi0Policy through the serving group.

The steps are held to `jax.jit` of the JAX package's single-device step on
the same global micro-batches and draws (tests/test_parallel_train.py's
tolerances: loss rtol 1e-4, params 1e-4 abs), with the int8 tower's codes
bit-unchanged; the fp32 policy to the JAX package's single-device Pi0Policy
(2e-4) on its first noise draw; int8 serving and the 8-bit moments bit-equal
to the port on one rank. The ranks of one batch coordinate take the same
rows and hold their outputs bit-equal.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_distributed as dist_test
import test_torch_tensor_parallel_ranks as child
from intact_tpu.models import common as jcm
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.models.pi0.policy import Pi0Policy as JPi0Policy
from intact_tpu.train import optim8bit as j8
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import make_optimizer as j_make_optimizer
from intact_tpu.train.train_step import init_train_state as j_init_state
from intact_tpu.train.train_step import make_train_step as j_make_step
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.ops import flash_attention as fa
from intact_tpu_torch.ops import w8a8
from intact_tpu_torch.train import checkpoint as ckpt
from intact_tpu_torch.train import optim8bit as t8

JOIN_TIMEOUT = dist_test.JOIN_TIMEOUT
JAX_TOL = 2e-4  # the policy against the JAX package's (tests/test_parallel_train.py)
ROWS = 8
# the expert-only step's grad_norm against the JAX gradients over a batch coordinate's rows: the port on one rank,
# without a group, is 1.15e-4 away on one of the 4 coordinates of 2 rows (an int8 code of the frozen prefix
# rounded the other way), so the ranks are held at 1e-3; the joint step's (float prefix) at 1e-4
EXPERT_GNORM_RTOL = 1e-3
CKPT_OVERRIDES = {"master_dtype": "float32", "use_bf16": "false", "global_batch_size": 4, "n_updates": 2}


def jax_config(name: str, expert: bool = False) -> JPi0Config:
    cfg = JPi0Config.tiny()
    if name == "tiny4":
        cfg = dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, num_heads=4),
                                  expert=dataclasses.replace(cfg.expert, num_heads=4))
    return dataclasses.replace(cfg, train_expert_only=expert)


def std_task(name: str, expert: bool, rng: np.random.Generator) -> tuple[dict, object]:
    """(the ranks' inputs, a function computing the JAX step's losses and
    params) of a standard-step task."""
    jcfg = jax_config(name, expert)
    jparams = jax.jit(jpi0.init, static_argnums=1)(jax.random.key(0), jcfg)
    jmask = None
    if expert:  # the frozen tower in int8, as quantize_frozen_int8 stores it
        mask = jax.tree.map(lambda _: True, jparams)
        for k in dist_test.FROZEN:
            mask[k] = jax.tree.map(lambda _: False, jparams[k])
        jparams = jax.jit(lambda p, m=mask: jcm.quantize_frozen(p, m))(jparams)
        jmask = {k: jax.tree.map(lambda _, t=k not in dist_test.FROZEN: t, v) for k, v in jparams.items()}
    # the 4-head variant's joint step at eps 1e-3, as the expert-only recipe's (tests/test_torch_distributed.py):
    # at 1e-8 Adam's first step moves an element whose gradient lies below the two packages' rounding agreement
    # by +-lr, the sign set by rounding (one q element of 4096 here, on one rank as on four)
    opt = dist_test.EXPERT_OPT if expert else {**dist_test.STD_OPT, "eps": 1e-3} if name == "tiny4" else \
        dist_test.STD_OPT
    batches = [dist_test.make_batch(jcfg, ROWS, rng) for _ in range(2)]
    draws = dist_test.jax_draws(jcfg, 2, batches[0]["actions"].shape)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), child.config(name, expert), device="cpu")
    port = {"config": name, "expert": expert, "params": tcm.flatten_paths(tparams), "opt": opt,
            "mask": None if jmask is None else tcm.flatten_paths(
                {k: tcm.tree_map(lambda _, t=k not in dist_test.FROZEN: t, v) for k, v in tparams.items()}),
            "batches": [dist_test.tensors(b) for b in batches], "noise": [torch.from_numpy(n) for n, _ in draws],
            "time": [torch.from_numpy(t) for _, t in draws]}

    def reference() -> dict:
        jtx, _ = j_make_optimizer(JOpt(**opt), jmask)
        step = jax.jit(j_make_step(lambda p, k, b: jpi0.compute_loss(p, k, b, jcfg, dist_test.J32), jtx,
                                   dist_test.J32, trainable_mask=jmask))
        state = j_init_state(jparams, jtx, seed=0)
        losses, norms = [], []
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["l2_loss"]))
            norms.append([float(m["grad_norm"]), float(m["param_norm"])])
        params = tcm.flatten_paths(jax.tree.map(np.asarray, state.params))
        return {"losses": losses, "norms": norms,
                "coordinates": {n: coordinate_grads(jcfg, jparams, jmask, batches, draws, n)
                                for n in ((2, 4) if name == "tiny" else ())},
                "params": {k: np.swapaxes(v, -1, -2) if k.endswith("kernel_q") else v for k, v in params.items()}}

    return port, reference


def coordinate_grads(jcfg, jparams, jmask, batches: list, draws: list, parts: int) -> list:
    """[micro-step][coordinate] {path: gradient} of the trainable leaves: the
    JAX loss's gradient over one of `parts` batch coordinates' rows (local_rows'
    blocks) with the JAX step's draws for those rows, at the initial params
    (accumulation 2: both micro-steps come before the update)."""
    flat = tcm.flatten_paths(jparams)
    trainable = tcm.flatten_paths(jmask) if jmask is not None else dict.fromkeys(flat, True)

    def loss(train, batch, noise, time_):
        saved = jpi0.sample_noise, jpi0.sample_time
        jpi0.sample_noise, jpi0.sample_time = (lambda key, shape: noise), (lambda key, b, cfg: time_)
        try:  # traced once per shape, with the given draws in place of the step's
            return jpi0.compute_loss(tcm.unflatten_paths({**flat, **train}), jax.random.key(0), batch, jcfg,
                                     dist_test.J32)[0]
        finally:
            jpi0.sample_noise, jpi0.sample_time = saved

    grad = jax.jit(jax.grad(loss))
    per = ROWS // parts
    return [[{k: np.asarray(g) for k, g in grad({k: v for k, v in flat.items() if trainable[k]},
                                                 *[jax.tree.map(lambda x: jnp.asarray(x[c * per:(c + 1) * per]), a)
                                                   for a in (batch, noise, time_)]).items()}
             for c in range(parts)] for batch, (noise, time_) in zip(batches, draws)]


def expected_grad_norms(ref: dict, rank: dict, mesh: tuple) -> list:
    """The step's grad_norm on `rank` per micro-step: at one batch coordinate
    the JAX step's; at several, one rank's scale of the JAX gradients over
    the coordinates' rows: its own rows' for a leaf it does not hold split
    over fsdp, the mean over its data replica's fsdp coordinates for one it
    does."""
    data, fsdp, _ = mesh
    if data * fsdp == 1:
        return [n[0] for n in ref["norms"]]
    c = rank["batch_index"]
    replica = range(c // fsdp * fsdp, (c // fsdp + 1) * fsdp)
    out = []
    for grads in ref["coordinates"][data * fsdp]:
        total = 0.0
        for k, g in grads[c].items():
            if k in rank["fsdp_split"]:
                g = np.mean([grads[o][k] for o in replica], axis=0)
            total += np.square(g.astype(np.float64)).sum()
        out.append(np.sqrt(total))
    return out


def policy_task(name: str, rng: np.random.Generator) -> tuple[dict, object]:
    """(the ranks' inputs, a function computing the JAX package's
    single-device Pi0Policy actions) on its weights and its first noise draw."""
    jcfg = jax_config(name)
    jpolicy = JPi0Policy(jcfg, seed=0, use_bf16=False, tokenizer_path="hash")
    key = jax.random.split(jax.random.key(0))[1]  # the JAX policy's first draw
    noise = np.array(jpi0.sample_noise(key, (ROWS, jcfg.chunk_size, jcfg.max_action_dim)))
    size = jcfg.vision.image_size
    batch = {"image": rng.uniform(-1, 1, (ROWS, size, size, 3)).astype(np.float32),
             "state": rng.normal(size=(ROWS, 7)).astype(np.float32),
             "task": [f"put object {i} on the plate" for i in range(ROWS)]}
    params = convert.from_jax_params(jax.tree.map(np.asarray, jpolicy.params), child.config(name), device="cpu")
    return ({"params": tcm.flatten_paths(params), "noise": torch.from_numpy(noise), "batch": batch},
            lambda: jpolicy.sample_action_chunk(dict(batch)))


def moment_cases(rng: np.random.Generator) -> dict:
    """Leaves of 4.5 blocks of 2048 (blocks straddle the slices' rows), with
    two whole gradients each: a column-parallel kernel (fsdp on dim 1, tensor
    on the last, strided in the flat leaf) and a row-parallel one (tensor on
    dim 1, fsdp on the last)."""
    cases = {}
    for case, path in (("column", "vlm/blocks/mlp/gate/kernel"), ("row", "vlm/blocks/mlp/down/kernel")):
        whole = torch.from_numpy(rng.standard_normal((3, 64, 48), dtype=np.float32))
        grads = [torch.from_numpy(rng.standard_normal((3, 64, 48), dtype=np.float32)) * s for s in (1.0, 0.3)]
        cases[case] = (path, whole, grads)
    return cases


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Write the ranks' inputs, spawn the three groups, compute the JAX and
    one-rank references meanwhile, join, and hand everything to the tests."""
    workdir = tmp_path_factory.mktemp("tensor_ranks")
    mp_ = pytest.MonkeyPatch()
    dist_test.tiny_pipeline(mp_)
    mp_.setattr(j8, "adamw8bit", functools.partial(j8.adamw8bit, min_quant_elems=dist_test.MIN_QUANT))
    try:
        rng = np.random.default_rng(11)
        std, later = {}, {}
        for task, name, expert in (("joint", "tiny", False), ("expert", "tiny", True), ("joint4", "tiny4", False),
                                   ("expert4", "tiny4", True)):
            std[task], later[task] = std_task(name, expert, rng)
        policy = {}
        for name in ("tiny", "tiny4"):
            policy[name], later[f"policy_{name}"] = policy_task(name, rng)
        ckpt_batches = [dist_test.make_batch(JPi0Config.tiny(), 4, rng) for _ in range(2)]
        inputs = {"std": std, "policy": policy, "moments": moment_cases(rng), "ckpt_overrides": CKPT_OVERRIDES,
                  "ckpt_batches": [dist_test.tensors(b) for b in ckpt_batches],
                  "ckpt_noise": [torch.from_numpy(rng.standard_normal((4, 4, 8), dtype=np.float32)) for _ in range(2)],
                  "ckpt_time": [torch.from_numpy(rng.uniform(0.1, 0.9, 4).astype(np.float32)) for _ in range(2)]}
        torch.save(inputs, workdir / "inputs.pt")
        deadline = time.monotonic() + JOIN_TIMEOUT
        contexts = {"pair": dist_test.spawn(child.pair, 2, workdir), "quad": dist_test.spawn(child.quad, 4, workdir),
                    "octo": dist_test.spawn(child.octo, 8, workdir)}
        try:
            refs = {k: fn() for k, fn in later.items()}
            refs.update(one_rank_references(inputs))
        except BaseException:
            for ctx in contexts.values():
                for p in ctx.processes:
                    p.kill()
            raise
        for name, ctx in contexts.items():
            dist_test.join(ctx, deadline, name)
        return {"workdir": workdir, "refs": refs, "inputs": inputs,
                **{name: [torch.load(workdir / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]
                   for name, world in (("pair", 2), ("quad", 4), ("octo", 8))}}
    finally:
        mp_.undo()


def one_rank_references(inputs: dict) -> dict:
    """The port's int8 Pi0Policy on one rank, on the JAX policy's weights and
    noise, on one thread as the ranks run (a float product's summation order
    follows the thread count)."""
    from intact_tpu_torch.models.pi0.policy import Pi0Policy

    spec = inputs["policy"]["tiny"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        policy = Pi0Policy(child.config("tiny"), params=tcm.unflatten_paths(dict(spec["params"])), use_bf16=False,
                           tokenizer_path="hash", device="cpu", quantize=True)
        arrays = [policy._put(x) for x in policy.prepare_inputs(spec["batch"])]
        return {"policy_int8": policy._sample_rows(*arrays, noise=spec["noise"])}
    finally:
        torch.set_num_threads(threads)


def assert_step(ranks: list, ref: dict, mesh: tuple, gnorm_rtol: float = 1e-4) -> None:
    """Per micro-step the mean over the batch coordinates of their losses,
    each rank's grad_norm and param_norm, and the params after the update,
    against the JAX step (grad_norm at several coordinates against the JAX
    gradients over their rows: `expected_grad_norms`); the ranks of one
    coordinate equal, every rank's params equal."""
    data, fsdp, tensor = mesh
    for r in ranks:
        dist_test.assert_equal_trees(r["params"], ranks[0]["params"], "ranks' params")
        norms = np.array(r["norms"])
        np.testing.assert_allclose(norms[:, 0], expected_grad_norms(ref, r, mesh), rtol=gnorm_rtol,
                                   err_msg="grad_norm")
        np.testing.assert_allclose(norms[:, 1], [n[1] for n in ref["norms"]], rtol=1e-4, err_msg="param_norm")
    for c in range(data * fsdp):
        coord = [r for r in ranks if r["batch_index"] == c]
        assert len(coord) == tensor and all(r["losses"] == coord[0]["losses"] for r in coord)
    losses = np.mean([r["losses"] for r in ranks[::tensor]], axis=0)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    dist_test.assert_params_close({k: v.float().numpy() for k, v in ranks[0]["params"].items()}, ref["params"],
                                  1e-4, f"mesh {mesh}")


SPLIT = {"vlm_embed/embedding", "vlm/blocks/attn/q/kernel", "vlm/blocks/attn/o/kernel",
         "vlm/blocks/mlp/gate/kernel", "vlm/blocks/mlp/up/kernel", "vlm/blocks/mlp/down/kernel",
         "expert/blocks/attn/q/kernel", "expert/blocks/attn/o/kernel", "expert/blocks/mlp/down/kernel"}
PARTIAL = ["expert/blocks/attn/k/kernel", "expert/blocks/attn/v/kernel", "siglip/blocks/attn/k/bias",
           "siglip/blocks/attn/q/bias", "siglip/blocks/attn/v/bias", "vlm/blocks/attn/k/kernel",
           "vlm/blocks/attn/v/kernel"]


@pytest.mark.parametrize("group,key,mesh", [
    ("pair", "std", (1, 1, 2)), ("quad", "std_1x2x2", (1, 2, 2)), ("quad", "std_2x1x2", (2, 1, 2)),
    ("quad", "std_1x1x4", (1, 1, 4)), ("octo", "std", (2, 2, 2)),
], ids=["1x1x2", "1x2x2", "2x1x2", "1x1x4", "2x2x2"])
def test_standard_step_matches_jax_single_device(groups, group, key, mesh):
    """Pi0's joint recipe at each mesh against jax.jit of the single-device
    step; the q, o, MLP and embedding leaves held as tensor slices, the
    one-head K/V kernels and SigLIP's q/k/v biases replicated with their
    gradient summed over tensor, the patch embed whole; at tensor 4 SigLIP
    (4 heads of the tiny tower, one per rank) splits too. Nothing is
    all-gathered over tensor."""
    ranks = [res[key] for res in groups[group]]
    assert_step(ranks, groups["refs"]["joint4" if mesh[2] == 4 else "joint"], mesh)
    assert SPLIT <= set(ranks[0]["split"]) and not {"vlm/blocks/attn/k/kernel", "siglip/patch_embed/kernel"} & set(
        ranks[0]["split"])
    assert ranks[0]["partial"] == PARTIAL
    coll = ranks[0]["collectives"]
    assert coll["tensor_all_reduce"] > 0 and coll["tensor_all_gather"] == 0
    assert (coll["bucket_all_gather"] > 0) == (mesh[1] > 1)


@pytest.mark.parametrize("group,key,mesh", [
    ("pair", "expert", (1, 1, 2)), ("quad", "expert_2x1x2", (2, 1, 2)), ("quad", "expert_1x1x4", (1, 1, 4)),
    ("octo", "expert", (2, 2, 2)),
], ids=["1x1x2", "2x1x2", "1x1x4", "2x2x2"])
def test_int8_frozen_expert_only_step_matches_jax(groups, group, key, mesh):
    """The expert-only step on the int8-frozen prefix (its row-parallel
    products through the whole-row scales): the expert's update against the
    JAX step, the int8 tower bit-unchanged."""
    ranks = [res[key] for res in groups[group]]
    task = "expert4" if mesh[2] == 4 else "expert"
    # grad_norm at EXPERT_GNORM_RTOL: over a coordinate's 2 rows an int8 code of the frozen prefix may round the
    # other way in the port than in the JAX package, on one rank as on the ranks
    assert_step(ranks, groups["refs"][task], mesh, gnorm_rtol=EXPERT_GNORM_RTOL)
    init = groups["inputs"]["std"][task]["params"]
    for path in ("vlm/blocks/attn/q/kernel_q", "vlm/blocks/mlp/down/kernel_q", "siglip/blocks/mlp/fc2/kernel_q"):
        assert torch.equal(ranks[0]["params"][path], init[path]), path
    assert {"vlm/blocks/attn/o/kernel_q", "expert/blocks/attn/q/kernel"} <= set(ranks[0]["split"])
    assert ranks[0]["partial"] == ["expert/blocks/attn/k/kernel", "expert/blocks/attn/v/kernel"]
    assert ranks[0]["collectives"]["tensor_all_reduce_max"] > 0


@pytest.mark.parametrize("group,key,name", [("pair", "policy", "tiny"), ("quad", "policy_1x1x4", "tiny4"),
                                            ("octo", "policy", "tiny")], ids=["1x1x2", "1x1x4", "2x2x2"])
def test_policy_matches_jax_single_device(groups, group, key, name):
    """Pi0Policy on its tensor slices: the gathered actions against the JAX
    package's single-device policy on its first noise draw (2e-4); the
    tensor ranks of one coordinate bit-equal."""
    ranks = [res[key] for res in groups[group]]
    want = groups["refs"][f"policy_{name}"]
    got = ranks[0]["gathered"].numpy()
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
    for r in ranks:
        same = [o for o in ranks if o["batch_index"] == r["batch_index"]]
        assert all(torch.equal(o["own"], r["own"]) for o in same)
    assert "vlm/blocks/attn/q/kernel" in ranks[0]["split"] and ranks[0]["collectives"]["tensor_all_reduce"] > 0


@pytest.mark.parametrize("group,key", [("pair", "policy_int8"), ("quad", "policy_int8_1x2x2")],
                         ids=["1x1x2", "1x2x2"])
def test_int8_serving_is_one_ranks_bit_for_bit(groups, group, key):
    """int8 serving over tensor: every row-parallel W8A8 product quantized
    against the whole row's absmax and its int32 partials summed, so the
    actions equal the one-rank policy's bit for bit."""
    ranks = [res[key] for res in groups[group]]
    assert torch.equal(ranks[0]["gathered"], groups["refs"]["policy_int8"])
    assert all(torch.equal(r["own"], ranks[0]["own"]) for r in ranks if r["batch_index"] == 0)
    assert "vlm/blocks/mlp/down/kernel_q" in ranks[0]["split"]
    assert ranks[0]["collectives"]["tensor_all_reduce_max"] > 0


@pytest.mark.parametrize("group,key", [("pair", "moments"), ("quad", "moments_1x2x2")], ids=["1x1x2", "1x2x2"])
def test_8bit_moments_of_a_tensor_slice_are_one_ranks(groups, group, key):
    """adam8bit_slice on a tensor slice (its last dimension strided in the
    flat leaf), and on its fsdp part: codes, block scales and directions bit
    for bit one rank's adam8bit_leaf."""
    for res in groups[group]:
        checks = res[key]
        assert all(c["equal"] and c["tensor"] for c in checks.values()), checks
        assert not checks["column"]["contiguous"]
        assert all(c["fsdp"] == (key != "moments") for c in checks.values())


def test_staged_collectives_equal_the_direct_ones(groups):
    """The staging rule (a CUDA tensor on a gloo group goes through the
    host) forced for CPU tensors: the five collectives give the direct ones'
    results, each counted once as staged and once as itself."""
    for res in groups["pair"]:
        assert res["staged"] == {"equal": True, "calls": 5, "counted": 1}


def test_checkpoint_from_1x2x2_resumes_on_one_rank(groups, monkeypatch):
    """The joint recipe's Trainer at (1, 2, 2) saves update 1 from the ranks
    in the one-rank layout; resumed on one rank, its next update on the same
    global batch equals the ranks' uninterrupted run (1e-4 abs)."""
    from intact_tpu_torch.train.trainer import Trainer

    ranks = [res["ckpt"] for res in groups["quad"]]
    assert ranks[0]["mesh"] == {"data": 1, "fsdp": 2, "tensor": 2} and SPLIT <= set(ranks[0]["split"])
    dist_test.assert_equal_trees(ranks[0]["params"], ranks[3]["params"], "ranks' params")
    dist_test.tiny_pipeline(monkeypatch)
    inputs = groups["inputs"]
    resumed = Trainer(child.dist_child.recipe_config(child.JOINT_RECIPE, **CKPT_OVERRIDES, **{
        "mesh.data": 1, "mesh.fsdp": 1, "per_device_batch_size": 4, "log_dir": groups["workdir"] / "one",
        "load_from_checkpoint": ranks[0]["saved"]}), device="cpu")
    assert resumed.cnt_update == 1 and resumed.mesh.size == 1
    saved = torch.load(f"{ranks[0]['saved']}/{ckpt.STATE_FILE}", weights_only=True)
    assert any(isinstance(m, dict) for m in saved["opt_state"]["mu"].values())  # 8-bit moments in the save
    resumed.state, _ = resumed.train_step(resumed.state, dict(inputs["ckpt_batches"][1]),
                                          noise=inputs["ckpt_noise"][1], time=inputs["ckpt_time"][1])
    dist_test.assert_params_close({k: v.numpy() for k, v in tcm.flatten_paths(resumed.state.params).items()},
                                  {k: v.numpy() for k, v in ranks[0]["params"].items()}, 1e-4, "resumed")


def test_stochastic_rounding_keeps_the_replicas_equal(groups):
    """The joint recipe as it is (bf16 masters, stochastic rounding) at
    (1, 2, 2): every rank's gathered params equal after the update (a tensor
    slice's fsdp part rounds with its own generator; the leaves replicated
    over tensor or fsdp round alike on their replicas), and the split leaves
    moved."""
    ranks = [res["rounded"] for res in groups["quad"]]
    assert ranks[0]["bf16"]
    for r in ranks[1:]:
        dist_test.assert_equal_trees(r["params"], ranks[0]["params"], "ranks' params")
    assert {"vlm/blocks/attn/q/kernel", "vlm/blocks/attn/k/kernel", "siglip/patch_embed/kernel"} <= set(
        ranks[0]["moved"])


# ---------------------------------------------------------------------------
# without a group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_parallel_w8a8_plain_path_is_the_one_card_product(parts, dtype):
    """The row-parallel entry's plain versions on K / parts slices (each
    slice's row absmax, their max, the int32 partials summed, the finish
    pass) bit-equal to w8a8_matmul on the whole rows, with and without a
    bias, at Pi0's ragged K / 4 of SigLIP's fc2 (1076)."""
    gen = torch.Generator().manual_seed(parts)
    for m, k, n in ((37, 256, 40), (5, 4304, 24)):
        x = torch.randn(m, k, generator=gen).to(dtype) * 3
        q = tcm.quantize_dense({"kernel": torch.randn(k, n, generator=gen), "bias": torch.randn(n, generator=gen)})
        for bias in (None, q["bias"]):
            want = w8a8.w8a8_matmul(x, q["kernel_q"], q["kernel_scale"], bias, out_dtype=dtype, weight_layout="nk")
            width = k // parts
            cols = [slice(i * width, (i + 1) * width) for i in range(parts)]
            amax = torch.stack([w8a8.row_absmax(x[:, c]) for c in cols]).amax(dim=0)
            partials = [w8a8.w8a8_partial(x[:, c], q["kernel_q"][:, c], amax, weight_layout="nk") for c in cols]
            total = torch.stack([p for p, _ in partials]).sum(dim=0, dtype=torch.int32)
            got = w8a8.w8a8_finish(total, partials[0][1], q["kernel_scale"], bias, out_dtype=dtype)
            assert got.dtype == dtype and torch.equal(got, want), (m, k, n, bias is None)


@pytest.mark.parametrize("heads", [4, 2])
def test_flash_attention_takes_local_heads(heads):
    """The kernel's shape checks take a tensor rank's H / t query heads over
    the one K/V head (Pi0's 8 heads at t = 2 and 4), and the plain version on
    local heads is the full output's slice of those heads."""
    gen = torch.Generator().manual_seed(heads)
    b, t, d = 2, 64, 256
    q = torch.randn(b, t, 8, d, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, t, 1, d, generator=gen).to(torch.bfloat16) for _ in range(2))
    mask = torch.rand(b, t, t, generator=gen) > 0.3
    fa._check(q[:, :, :heads].contiguous(), k, v, mask)
    full = fa.flash_attention_reference(q, k, v, mask)
    for r in range(8 // heads):
        local = fa.flash_attention_reference(q[:, :, r * heads:(r + 1) * heads], k, v, mask)
        assert torch.equal(local, full[:, :, r * heads:(r + 1) * heads])


@pytest.mark.parametrize("model_type", ["pi0fast_tiny", "mvla_tiny", "mmmvla_tiny", "spatialvla_native_tiny",
                                        "magma_native_tiny", "octo_tiny", "spatialvla", "magma", "pi0-fused"])
def test_every_other_path_refuses_the_tensor_axis(model_type):
    """What the tensor-parallel slice leaves out refuses tensor > 1 with a
    reason that names the slice: training every family but Pi0 (Pi0FAST's,
    SpatialVLA's and Magma's among them), serving MVLA, mmmvla, Octo and the
    HF-scaffold types, and the fused step; Pi0's training and tensor 1
    pass."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.parallel.mesh import TENSOR_SERVING_FAMILIES, MeshConfig, refuse_tensor

    fused = model_type == "pi0-fused"
    family = "pi0" if fused else registry.family(model_type)
    slice_named = "tensor axis .* not ported .*serving Pi0, Pi0FAST, native SpatialVLA and native Magma"
    with pytest.raises(NotImplementedError, match=slice_named):
        refuse_tensor(MeshConfig(data=1, fsdp=1, tensor=2), family, fused=fused)
    if fused or family not in TENSOR_SERVING_FAMILIES:
        with pytest.raises(NotImplementedError, match=slice_named):
            refuse_tensor(MeshConfig(data=1, fsdp=1, tensor=2), family, fused=fused, serving=True)
    refuse_tensor(MeshConfig(data=1, fsdp=2, tensor=1), family, fused=fused)
    refuse_tensor(MeshConfig(data=1, fsdp=1, tensor=2), registry.family("pi0_tiny"))


@pytest.mark.parametrize("model_type", ["pi0fast_tiny", "spatialvla_native_tiny", "magma_native_tiny", "pi0_tiny"])
def test_serving_takes_the_tensor_axis_for_the_token_decoding_families(model_type):
    """Serving Pi0, Pi0FAST, native SpatialVLA and native Magma passes at
    tensor 2 and 4 (the trainer's refusal of the last three stands)."""
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.parallel.mesh import MeshConfig, refuse_tensor

    for tensor in (2, 4):
        refuse_tensor(MeshConfig(data=1, fsdp=1, tensor=tensor), registry.family(model_type), serving=True)


def test_policy_refuses_the_tensor_axis_for_mvla():
    """Pi0Policy with MVLA's module on a tensor-2 mesh refuses before
    building anything; with Pi0FAST's it holds its tensor slices."""
    from intact_tpu_torch.models.mvla import model as mvla
    from intact_tpu_torch.models.mvla.config import MVLAConfig
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.parallel.mesh import Mesh

    from intact_tpu_torch.models.pi0fast import model as fast
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
    from intact_tpu_torch.parallel.sharding import Sharded

    mesh = Mesh(1, 1, 2, 0, dict.fromkeys(("data", "fsdp", "tensor", "batch", "model", "world")))
    with pytest.raises(NotImplementedError, match="tensor axis .* serving mvla"):
        Pi0Policy(MVLAConfig.tiny(), tokenizer_path="hash", device="cpu", model_module=mvla, mesh=mesh)
    policy = Pi0Policy(Pi0FASTConfig.tiny(), tokenizer_path="hash", device="cpu", model_module=fast, mesh=mesh)
    q, k = (policy.params["vlm"]["blocks"]["attn"][n]["kernel"] for n in ("q", "k"))
    assert isinstance(q, Sharded) and q.tensor.parts == 2 and not isinstance(k, Sharded)


def test_rules_keep_the_tensor_axis_at_head_granularity():
    """At tensor 2 the rules split Pi0's query heads and MLP columns and keep
    the one-head K/V and the patch embed whole; at tensor 1 the axis goes, as before; without
    the heads no projection splits over tensor."""
    from intact_tpu_torch.models.pi0 import model as tpi0
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.parallel import sharding
    from intact_tpu_torch.parallel.mesh import Mesh

    cfg = Pi0Config.bridge()
    heads = tpi0.tensor_heads(cfg)
    mesh = Mesh(1, 2, 2, 0, dict.fromkeys(("data", "fsdp", "tensor", "batch", "model", "world")))
    spec = functools.partial(sharding.spec_for_path, mesh=mesh, heads=heads)
    assert spec("vlm/blocks/attn/q/kernel", (18, 2048, 2048)) == (None, "fsdp", "tensor")
    assert spec("vlm/blocks/attn/k/kernel", (18, 2048, 256)) == (None, "fsdp", None)
    assert spec("vlm/blocks/attn/o/kernel_q", (18, 2048, 2048)) == (None, "fsdp", "tensor")
    assert spec("vlm/blocks/mlp/down/kernel", (18, 16384, 2048)) == (None, "tensor", "fsdp")
    assert spec("siglip/blocks/attn/v/kernel", (27, 1152, 1152)) == (None, "fsdp", "tensor")
    assert spec("siglip/blocks/mlp/fc1/bias", (27, 4304)) == (None, "tensor")
    assert spec("vlm_embed/embedding", (257152, 2048)) == ("tensor", "fsdp")
    assert spec("siglip/patch_embed/kernel", (14, 14, 3, 1152)) == (None, None, None, None)
    assert sharding.spec_for_path("vlm/blocks/attn/q/kernel", (18, 2048, 2048), mesh) == (None, "fsdp", None)
    one = Mesh(1, 2, 1, 0, mesh.groups)
    assert sharding.spec_for_path("vlm/blocks/attn/q/kernel", (18, 2048, 2048), one, heads=heads) == (
        None, "fsdp", None)


def test_8bit_slice_layout_is_the_flat_leafs():
    """A tensor slice's fsdp part maps each of its elements to the whole
    leaf's flat index (the layout the 8-bit moments' blocks are read in)."""
    from intact_tpu_torch.parallel.sharding import TensorSplit

    whole = torch.arange(3 * 8 * 6).view(3, 8, 6)
    for tdim, fdim in ((2, 1), (1, 2)):
        for ti in range(2):
            for fi in range(2):
                t_shape = list(whole.shape)
                t_shape[tdim] //= 2
                tsplit = TensorSplit(tdim, 2, ti, None, tuple(whole.shape))
                layout = t8.slice_layout(tuple(t_shape), fdim, 2, fi, tsplit)
                piece = whole.narrow(tdim, ti * t_shape[tdim], t_shape[tdim])
                piece = piece.narrow(fdim, fi * t_shape[fdim] // 2, t_shape[fdim] // 2).reshape(-1)
                assert torch.equal(layout.where(0, piece.numel(), "cpu"), piece)
                assert [layout.at(e) for e in (0, 5, piece.numel() - 1)] == piece[[0, 5, -1]].tolist()
