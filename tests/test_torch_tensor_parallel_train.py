"""The tensor axis for the last two training paths: Pi0FAST's standard step and
Pi0's fused joint step, on spawned gloo groups on the CPU
(tests/test_torch_tensor_parallel_train_ranks.py).

Two groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, each joined within JOIN_TIMEOUT or the test fails
(its processes are killed):

  * two ranks, mesh (1, 1, 2): Pi0FAST's step at a vocabulary that 2 and 4
    divide (256) and at one that none does (99: the table stays whole), the
    vocabulary-parallel cross entropy at t = 2, the fused step and its
    update fed one card's gradients, the Pi0FAST and fused trainers (one
    update with validation, the save), and a one-rank Pi0FAST save resumed;
  * four ranks: Pi0FAST's step at (1, 2, 2) and at (1, 1, 4) (its 4-head
    variant), the cross entropy at t = 4, the fused step at (1, 2, 2) and
    (2, 1, 2), the fed update at (1, 2, 2).

Held, in fp32: Pi0FAST's step against `jax.jit` of the JAX package's
single-device step on the same two global micro-batches (loss rtol 1e-4,
grad_norm 1e-4 at each batch coordinate against the JAX gradients over its
rows, params 1e-4 abs, token_accuracy equal); the cross entropy against
F.cross_entropy over the whole logits (value and gradient, 1e-6); the fused
step against `jax.jit` of the JAX fused step (update_impl "leaf", the Pallas
kernel in interpret mode) on the whole batch, run as tests/test_torch_train.py
runs it (loss and grad_norm rtol 1e-5, params rtol 2e-4 plus 1e-4 abs).
In bf16 with stochastic rounding and 8-bit moments, the fused update fed one
card's gradient is one rank's bit for bit, params and gathered moments.
Checkpoints saved at tensor 2 resume on one rank.
"""

import dataclasses
import functools
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_distributed as dist_test
import test_torch_tensor_parallel as tp_test
import test_torch_tensor_parallel_train_ranks as child
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.models.pi0fast import model as jfast
from intact_tpu.models.pi0fast.config import Pi0FASTConfig as JFASTConfig
from intact_tpu.train import fused_joint as jfj
from intact_tpu.train import optim8bit as j8
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import make_optimizer as j_make_optimizer
from intact_tpu.train.train_step import init_train_state as j_init_state
from intact_tpu.train.train_step import make_train_step as j_make_step
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.train import checkpoint as ckpt
from intact_tpu_torch.train import fused_joint as tfj

JOIN_TIMEOUT = dist_test.JOIN_TIMEOUT
J32 = dist_test.J32
ROWS = 4
EVEN, RAGGED = 256, 99  # 2 and 4 divide the first; no t divides the second (the table stays whole)
FAST_OPT = dist_test.STD_OPT  # 8-bit AdamW with the tiny leaves quantized, an active clip, accumulation 2
# the 4-head variant at eps 1e-3, as tests/test_torch_tensor_parallel.py's 4-head Pi0: at 1e-8 Adam's first step
# moves an element whose gradient lies below the two packages' rounding agreement by +-lr, the sign set by
# rounding (the port on one rank without a group is already 8.8e-5 from the JAX step in vlm/blocks/attn/o/kernel)
FAST_OPT4 = {**FAST_OPT, "eps": 1e-3}
# the fused step's optimizer, as tests/test_torch_train.py's with the delayed clip active at the second step
FUSED_OPT = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=2, first_cycle_steps=100, max_grad_norm=1.0)
STRUCTURALLY_ZERO = dist_test.STRUCTURALLY_ZERO
FAST_CASES = [(f"{name}-{kind}", name, vocab) for name in ("tiny", "tiny4") for kind, vocab in
              (("even", EVEN), ("ragged", RAGGED))]


def jax_fast_config(name: str, vocab: int) -> JFASTConfig:
    cfg = JFASTConfig.tiny()
    vlm = dataclasses.replace(cfg.vlm, vocab_size=vocab, num_heads=4 if name == "tiny4" else cfg.vlm.num_heads)
    return dataclasses.replace(cfg, vlm=vlm)


def fast_task(name: str, vocab: int, rng: np.random.Generator) -> tuple[dict, object]:
    """(the ranks' inputs, the JAX reference's job) of Pi0FAST's step at a
    config and vocabulary: the step's losses, norms and params over two
    4-row micro-batches, and each of two batch coordinates' loss, token
    accuracy and gradients at the initial params (accumulation 2: both
    micro-steps come before the update)."""
    jcfg = jax_fast_config(name, vocab)
    jparams = jax.jit(jfast.init, static_argnums=1)(jax.random.key(1), jcfg)
    batches = [dist_test.make_batch(jcfg, ROWS, rng) for _ in range(2)]
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), child.fast_config(name, vocab), device="cpu")
    opt = FAST_OPT4 if name == "tiny4" else FAST_OPT
    port = {"config": (name, vocab), "params": tcm.flatten_paths(tparams), "opt": opt,
            "batches": [dist_test.tensors(b) for b in batches]}

    def reference() -> dict:
        jtx, _ = j_make_optimizer(JOpt(**opt), None)
        step = jax.jit(j_make_step(lambda p, k, b: jfast.compute_loss(p, k, b, jcfg, J32), jtx, J32))
        state = j_init_state(jparams, jtx, seed=0)
        losses, accs, norms = [], [], []
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["l2_loss"]))
            accs.append(float(m["token_accuracy"]))
            norms.append([float(m["grad_norm"]), float(m["param_norm"])])
        grad = jax.jit(jax.value_and_grad(lambda p, b: jfast.compute_loss(p, jax.random.key(0), b, jcfg, J32),
                                          has_aux=True))
        per = ROWS // 2
        coords, coord_accs = [], []
        for batch in batches:
            micro, micro_accs = [], []
            for c in range(2):
                (_, aux), g = grad(jparams, {k: jnp.asarray(v[c * per:(c + 1) * per]) for k, v in batch.items()})
                micro.append({k: np.asarray(v) for k, v in tcm.flatten_paths(g).items()})
                micro_accs.append(float(aux["token_accuracy"]))
            coords.append(micro)
            coord_accs.append(micro_accs)
        return {"losses": losses, "accs": accs, "norms": norms, "coordinates": {2: coords},
                "coordinate_accs": coord_accs, "params": tcm.flatten_paths(jax.tree.map(np.asarray, state.params))}

    return port, reference


def ce_cases(rng: np.random.Generator) -> dict:
    """{name: (logits [6, 40] fp32 over a table padded to 40 rows, targets,
    the vocabulary, an upstream gradient)}: a vocabulary of 40 (every
    column real), of 37 (the last rank's tail padded) and of 29 (at t = 4
    the last rank holds none of it); the padded columns hold large values,
    which must count as -inf."""
    out = {}
    for name, vocab in (("even", 40), ("padded", 37), ("rank_past", 29)):
        logits = torch.from_numpy(rng.standard_normal((6, 40), dtype=np.float32) * 3)
        logits[:, vocab:] = 50.0
        targets = torch.from_numpy(rng.integers(0, vocab, 6))
        out[name] = (logits, targets, vocab, torch.from_numpy(rng.uniform(0.5, 2.0, 6).astype(np.float32)))
    return out


def fused_task(rng: np.random.Generator) -> tuple[dict, object]:
    """(the ranks' inputs, the JAX fused step's job) on the tiny Pi0: two
    steps on the 4-row batch with the draws the JAX step takes from its
    state's key, which the ranks are handed; the one-card gradients of the
    fed update (two steps of every trainable leaf)."""
    jc = JPi0Config.tiny()
    jparams = jax.jit(jpi0.init, static_argnums=1)(jax.random.key(5), jc)
    batch = dist_test.make_batch(jc, ROWS, rng)
    key, draws = jax.random.key(7), []
    for _ in range(2):  # the step's draws: split(state.rng, 3) -> (next key, flow key, salt key)
        key, k_flow, _ = jax.random.split(key, 3)
        k_noise, k_time = jax.random.split(k_flow)
        draws.append((np.array(jpi0.sample_noise(k_noise, batch["actions"].shape)),
                      np.array(jpi0.sample_time(k_time, ROWS, jc))))
    tparams = tcm.flatten_paths(convert.from_jax_params(jax.tree.map(np.asarray, jparams), child.tp_child.config(
        "tiny"), device="cpu"))
    port = {"params": tparams, "opt": FUSED_OPT, "batch": dist_test.tensors(batch),
            "noise": [torch.from_numpy(n) for n, _ in draws], "time": [torch.from_numpy(t) for _, t in draws]}
    fed = {"grads": [{k: torch.from_numpy(rng.standard_normal(tuple(v.shape), dtype=np.float32)) * 0.1
                      for k, v in tparams.items() if not k.startswith("vlm_embed/")} for _ in range(2)]}

    def reference() -> dict:
        js = jfj.init_fused_state(jparams, seed=7, min_quant_elems=child.FUSED_MIN_QUANT,
                                  block_size=child.FUSED_BLOCK)
        jstep = jax.jit(jfj.make_fused_joint_step(jc, JOpt(**FUSED_OPT), J32, pallas_mode="interpret",
                                                  update_impl="leaf", min_quant_elems=child.FUSED_MIN_QUANT,
                                                  block_size=child.FUSED_BLOCK, stochastic_rounding=False,
                                                  scale_mode="exact"))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        metrics = []
        for _ in range(2):
            js, m = jstep(js, jb)
            metrics.append((float(m["l2_loss"]), float(m["grad_norm"])))
        return {"metrics": metrics, "params": tcm.flatten_paths(jax.tree.map(np.asarray, js.params))}

    return port, fed, reference


def one_rank_fast_save(workdir) -> str:
    """pi0fast_finetune_bridge.yaml at pi0fast_tiny on one rank: one update,
    saved (the last update's save) -> its step dir."""
    from intact_tpu_torch.train.trainer import Trainer

    trainer = Trainer(child.dist_child.recipe_config(child.FAST_RECIPE, **{
        "model_cfg.type": "pi0fast_tiny", "mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 2,
        "n_updates": 1, "log_dir": workdir / "one_fast"}), device="cpu")
    trainer.train()
    return str(trainer.ckpt_root / "step_1")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Write the ranks' inputs, spawn the two groups, compute the JAX
    references meanwhile, join, and hand everything to the tests."""
    workdir = tmp_path_factory.mktemp("tensor_train_ranks")
    mp_ = pytest.MonkeyPatch()
    dist_test.tiny_pipeline(mp_)
    mp_.setattr(j8, "adamw8bit", functools.partial(j8.adamw8bit, min_quant_elems=dist_test.MIN_QUANT))
    try:
        rng = np.random.default_rng(20)
        fast, jobs = {}, {}
        for case, name, vocab in FAST_CASES:
            fast[case], jobs[case] = fast_task(name, vocab, rng)
        fused, fed, jobs["fused"] = fused_task(rng)
        inputs = {"fast": fast, "fused": fused, "fed": fed, "ce": ce_cases(rng), "min_quant": dist_test.MIN_QUANT,
                  "fast_save": one_rank_fast_save(workdir)}
        torch.save(inputs, workdir / "inputs.pt")
        deadline = time.monotonic() + JOIN_TIMEOUT
        contexts = {"pair": dist_test.spawn(child.pair, 2, workdir), "quad": dist_test.spawn(child.quad, 4, workdir)}
        try:
            with ThreadPoolExecutor(3) as pool:  # XLA compiles without the GIL
                running = {k: pool.submit(fn) for k, fn in jobs.items()}
                refs = {k: f.result() for k, f in running.items()}
        except BaseException:
            for ctx in contexts.values():
                for p in ctx.processes:
                    p.kill()
            raise
        for name, ctx in contexts.items():
            dist_test.join(ctx, deadline, name)
        return {"workdir": workdir, "refs": refs, "inputs": inputs,
                **{name: [torch.load(workdir / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]
                   for name, world in (("pair", 2), ("quad", 4))}}
    finally:
        mp_.undo()


# ---------------------------------------------------------------------------
# Pi0FAST's standard step
# ---------------------------------------------------------------------------

FAST_GRID = [("pair", "fast_even", (1, 1, 2), "tiny-even"), ("pair", "fast_ragged", (1, 1, 2), "tiny-ragged"),
             ("quad", "fast_even_1x2x2", (1, 2, 2), "tiny-even"),
             ("quad", "fast_ragged_1x2x2", (1, 2, 2), "tiny-ragged"),
             ("quad", "fast_even_1x1x4", (1, 1, 4), "tiny4-even"),
             ("quad", "fast_ragged_1x1x4", (1, 1, 4), "tiny4-ragged")]
# the leaves replicated over tensor whose gradient a rank holds in part: the one-head K/V kernels and SigLIP's
# q/k/v biases (the tied table is split over tensor, not partial)
FAST_PARTIAL = ["siglip/blocks/attn/k/bias", "siglip/blocks/attn/q/bias", "siglip/blocks/attn/v/bias",
                "vlm/blocks/attn/k/kernel", "vlm/blocks/attn/v/kernel"]


@pytest.mark.parametrize("group,key,mesh,case", FAST_GRID,
                         ids=[f"{'x'.join(map(str, m))}-{c.split('-')[1]}" for _, _, m, c in FAST_GRID])
def test_pi0fast_step_matches_jax_single_device(groups, group, key, mesh, case):
    """Pi0FAST's standard step against jax.jit of the single-device step:
    per micro-step the losses, grad_norm (at two batch coordinates against
    the JAX gradients over each one's rows) and param_norm, the params after
    the update (tests/test_torch_tensor_parallel.py's `assert_step`), and
    every rank's token accuracy equal to its coordinate's. The tied table is
    a vocabulary-parallel slice that trains (where its vocabulary divides),
    its two gradients on the rank's rows; the one-head K/V kernels and
    SigLIP's q/k/v biases summed over tensor; the cross entropy and the
    accuracy's argmax one MAX all-reduce each per micro-step."""
    ranks = [res[key] for res in groups[group]]
    ref = groups["refs"][case]
    tp_test.assert_step(ranks, ref, mesh)
    coords = mesh[0] * mesh[1]
    for r in ranks:
        want = ref["accs"] if coords == 1 else [a[r["batch_index"]] for a in ref["coordinate_accs"]]
        assert r["accs"] == want, "token_accuracy"
    split = set(ranks[0]["split"])
    divisible = case.endswith("even")
    assert ("vlm_embed/embedding" in split) == divisible
    assert {"vlm/blocks/mlp/gate/kernel", "vlm/blocks/mlp/down/kernel"} <= split
    assert ("vlm/blocks/attn/q/kernel" in split) and not {"vlm/blocks/attn/k/kernel"} & split
    assert ranks[0]["partial"] == FAST_PARTIAL
    coll = ranks[0]["collectives"]
    # per micro-step: the cross entropy's and the accuracy's argmax's MAX all-reduce where the table splits
    assert coll["tensor_all_reduce_max"] == (4 if divisible else 0)
    assert coll["tensor_all_reduce"] > 0 and coll["tensor_all_gather"] == 0
    assert (coll["bucket_all_gather"] > 0) == (mesh[1] > 1)


def test_table_trains_on_each_ranks_rows(groups):
    """The tied table at (1, 1, 2): each rank's rows moved (the lookup's rows
    and the head's columns both train it), and its update equals the JAX
    step's on both halves."""
    ranks = [res["fast_even"] for res in groups["pair"]]
    init = groups["inputs"]["fast"]["tiny-even"]["params"]["vlm_embed/embedding"]
    got = ranks[0]["params"]["vlm_embed/embedding"]
    for half in (slice(0, EVEN // 2), slice(EVEN // 2, EVEN)):
        assert not torch.equal(got[half], init[half])
    np.testing.assert_allclose(got.numpy(), groups["refs"]["tiny-even"]["params"]["vlm_embed/embedding"], atol=1e-4)


@pytest.mark.parametrize("group,key", [("pair", "ce"), ("quad", "ce_1x1x4")], ids=["t2", "t4"])
def test_vocab_cross_entropy_matches_the_whole_logits(groups, group, key):
    """The vocabulary-parallel cross entropy on each rank's columns: every
    rank's nll equals F.cross_entropy over the whole vocabulary's logits
    (1e-6), its columns' gradient the whole one's (zero past the vocabulary),
    one MAX all-reduce and one sum all-reduce per call."""
    for res in groups[group]:
        for name, got in res[key].items():
            logits, targets, vocab, upstream = groups["inputs"]["ce"][name]
            whole = logits.clone().requires_grad_()
            nll = F.cross_entropy(whole[:, :vocab], targets, reduction="none")
            (grad,) = torch.autograd.grad(nll, whole, upstream)
            n = logits.shape[-1] // len(groups[group])
            cols = slice(got["index"] * n, (got["index"] + 1) * n)
            np.testing.assert_allclose(got["nll"].numpy(), nll.detach().numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got["grad"].numpy(), grad[:, cols].numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
            assert got["collectives"]["tensor_all_reduce_max"] == got["collectives"]["tensor_all_reduce"] == 1


def test_rules_split_pi0fast_at_full_width():
    """At the full width the tied table (257,152 rows) splits over tensor 2
    and 4 by its vocabulary, Gemma's query heads and MLP split, its one K/V
    head stays whole; partial_paths names the one-head K/V kernels and
    SigLIP's q/k/v biases, never the table."""
    from intact_tpu_torch.models.pi0fast import model as tfast
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
    from intact_tpu_torch.parallel import sharding, tensor
    from intact_tpu_torch.parallel.mesh import Mesh
    from intact_tpu_torch.parallel.sharding import Sharded, TensorSplit

    heads = tfast.tensor_heads(Pi0FASTConfig())
    for t in (2, 4):
        mesh = Mesh(1, 2, t, 0, dict.fromkeys(("data", "fsdp", "tensor", "batch", "model", "world")))
        spec = functools.partial(sharding.spec_for_path, mesh=mesh, heads=heads)
        assert spec("vlm_embed/embedding", (257152, 2048)) == ("tensor", "fsdp")
        assert spec("vlm/blocks/attn/q/kernel", (18, 2048, 2048)) == (None, "fsdp", "tensor")
        assert spec("vlm/blocks/attn/v/kernel", (18, 2048, 256)) == (None, "fsdp", None)
        assert spec("vlm/blocks/mlp/down/kernel", (18, 16384, 2048)) == (None, "tensor", "fsdp")
    split = Sharded(torch.zeros(1), 0, (1,), None, 1, tensor=TensorSplit(1, 2, 0, None, (1,)))
    flat = {"vlm_embed/embedding": split, "vlm/blocks/attn/q/kernel": split, "vlm/blocks/attn/k/kernel": 0,
            "vlm/blocks/attn/v/kernel": 0, "siglip/blocks/attn/q/kernel": split, "siglip/blocks/attn/q/bias": 0,
            "siglip/blocks/attn/o/bias": 0, "state_proj/kernel": 0}
    assert tensor.partial_paths(flat) == {"vlm/blocks/attn/k/kernel", "vlm/blocks/attn/v/kernel",
                                          "siglip/blocks/attn/q/bias"}


# ---------------------------------------------------------------------------
# Pi0's fused joint step
# ---------------------------------------------------------------------------

FUSED_GRID = [("pair", "fused", (1, 1, 2)), ("quad", "fused_1x2x2", (1, 2, 2)), ("quad", "fused_2x1x2", (2, 1, 2))]


def bits(tree: dict) -> dict:
    """{path: tensor} with fp8 codes as their uint8 bits (torch.equal takes no fp8 on the CPU)."""
    fp8 = (torch.float8_e4m3fn, torch.float8_e5m2)
    return {k: v.view(torch.uint8) if isinstance(v, torch.Tensor) and v.dtype in fp8 else v for k, v in tree.items()}


def expected_kernel_rows(params: dict) -> tuple[int, int]:
    """(the rows the row update's kernel takes over two steps on one card:
    every kernel-eligible leaf of the two trunks at each layer and every
    eligible 8-bit leaf of the head and the embed side, `fused_joint`'s
    rules at block 8; the VLM pack's rows)."""
    from intact_tpu_torch.ops.fused_adam import eligible

    tree = tcm.unflatten_paths(params)
    rows = 0
    for tower in ("vlm", "expert"):
        pack = tfj.TrunkPack(tree[tower]["blocks"], child.FUSED_BLOCK)
        depth = next(iter(tcm.flatten_paths(tree[tower]["blocks"]).values())).shape[0]
        rows += depth * sum(r for n, r in zip(pack.sizes, pack.rows) if eligible(n, child.FUSED_BLOCK))
    rows += sum(v.numel() // child.FUSED_BLOCK for k, v in params.items()
                if k.split("/")[0] in tfj.EMBED_NAMES + ("action_out_proj",) and v.numel() >= child.FUSED_MIN_QUANT
                and eligible(v.numel(), child.FUSED_BLOCK))
    return 2 * rows, tfj.TrunkPack(tree["vlm"]["blocks"], child.FUSED_BLOCK).nb


@pytest.mark.parametrize("group,key,mesh", FUSED_GRID, ids=["1x1x2", "1x2x2", "2x1x2"])
def test_fused_step_matches_jax(groups, group, key, mesh):
    """The fused step on the ranks' tensor slices (fp32, SR off, 8-bit
    moments, the delayed clip active at the second step) against jax.jit of
    the JAX fused step on the whole batch: the mean over the batch
    coordinates of their losses, every rank's grad_norm and clip factor
    (equal on every rank), the params after two steps; every rank's params
    and gathered moments equal; the row kernel's plain version takes each
    rank's rows of the one-card packs, the model group's ranks all of them
    once."""
    ranks = [res[key] for res in groups[group]]
    ref = groups["refs"]["fused"]
    data, fsdp, tensor = mesh
    for r in ranks:
        dist_test.assert_equal_trees(r["params"], ranks[0]["params"], "ranks' params")
        for name in ("mu", "nu"):
            dist_test.assert_equal_trees(bits(r[name]), bits(ranks[0][name]), name)
        assert [m[1:] for m in r["metrics"]] == [m[1:] for m in ranks[0]["metrics"]]
    for step, (loss, gnorm) in enumerate(ref["metrics"]):
        got = np.mean([r["metrics"][step][0] for r in ranks[::tensor]])
        np.testing.assert_allclose(got, loss, rtol=1e-5, err_msg="loss")
        np.testing.assert_allclose(ranks[0]["metrics"][step][1], gnorm, rtol=1e-5, err_msg="grad_norm")
    assert ranks[0]["metrics"][0][2] == 1.0 and ranks[0]["metrics"][1][2] < 1.0  # the delayed clip
    init = groups["inputs"]["fused"]["params"]
    got, want = {k: v.numpy() for k, v in ranks[0]["params"].items()}, ref["params"]
    assert set(got) == set(want)
    for path in want:
        if path in STRUCTURALLY_ZERO:
            assert np.abs(got[path] - init[path].numpy()).max() <= 2 * 2 * FUSED_OPT["lr"]
            continue
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=1e-4, err_msg=path)
    np.testing.assert_array_equal(got["vlm_embed/embedding"], init["vlm_embed/embedding"].numpy())  # frozen
    assert {"vlm/blocks/attn/q/kernel", "expert/blocks/mlp/up/kernel", "vlm_embed/embedding"} <= set(ranks[0]["split"])
    replica = [r for r in ranks if r["batch_index"] // fsdp == 0]
    rows, nb = expected_kernel_rows(init)
    assert sum(r["kernel_rows"] for r in replica) == rows
    assert all(0 < r["kernel_rows"] for r in ranks) and all(r["local_rows"] < nb for r in ranks)
    coll = ranks[0]["collectives"]
    assert coll["reduce_scatter"] > 0 and coll["all_gather"] > 0 and coll["tensor_all_gather"] > 0


@pytest.mark.parametrize("group,key", [("pair", "fed"), ("quad", "fed_1x2x2")], ids=["1x1x2", "1x2x2"])
def test_fused_update_fed_one_cards_gradient_is_one_ranks(groups, group, key):
    """bf16 masters with stochastic rounding, 8-bit moments at block 8, the
    kernel's plain version: two updates of every trainable leaf fed one
    card's gradient (each rank its share: its tensor slices, a partial
    leaf's on tensor index 0) give params and gathered moments bit for bit
    one rank's, each rank holding its rows of the one-card packs."""
    for res in groups[group]:
        ranks, one = res[key]["ranks"], res[key]["one"]
        assert all(v.dtype == torch.bfloat16 for v in ranks["params"].values() if v.is_floating_point())
        dist_test.assert_equal_trees(ranks["params"], one["params"], "params")
        for name in ("mu", "nu"):
            dist_test.assert_equal_trees(bits(ranks[name]), bits(one[name]), name)
        moved = [k for k, v in one["params"].items() if not torch.equal(v, groups["inputs"]["fused"]["params"][k].to(
            v.dtype))]
        assert {"vlm/blocks/attn/q/kernel", "siglip/blocks/attn/q/bias", "expert/blocks/attn/k/kernel"} <= set(moved)
        assert ranks["split"] and 0 < ranks["local_rows"] < one["local_rows"]


# ---------------------------------------------------------------------------
# the trainers and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["fast", "fused"])
def test_trainer_checkpoint_at_tensor_2_resumes_on_one_rank(groups, monkeypatch, which):
    """pi0fast_finetune_bridge.yaml (at pi0fast_tiny) and the fused
    pi0_finetune_bridge_1chip.yaml (bf16 masters with stochastic rounding)
    through the Trainer at (1, 1, 2): one update, validation through the
    tensor-parallel sample_actions (finite, equal on both ranks), the save
    from the ranks; resumed on one rank, its params and optimizer state
    equal the ranks' gathered ones."""
    from intact_tpu_torch.train.trainer import Trainer

    ranks = [res[f"trainer_{which}"] for res in groups["pair"]]
    assert ranks[0]["mesh"] == {"data": 1, "fsdp": 1, "tensor": 2}
    assert "vlm/blocks/attn/q/kernel" in ranks[0]["split"]
    dist_test.assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    assert ranks[0]["validations"] == ranks[1]["validations"] and len(ranks[0]["validations"]) == 1
    assert np.isfinite(ranks[0]["validations"][0]["l1_loss"])
    dist_test.tiny_pipeline(monkeypatch)
    recipe, extra = (child.FAST_RECIPE, {"model_cfg.type": "pi0fast_tiny"}) if which == "fast" else (
        child.FUSED_RECIPE, {})
    resumed = Trainer(child.dist_child.recipe_config(recipe, **{
        "mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 2, "n_updates": 1,
        "log_dir": groups["workdir"] / f"resumed_{which}", "load_from_checkpoint": ranks[0]["saved"], **extra}),
        device="cpu")
    assert resumed.cnt_update == 1 and resumed.mesh.size == 1
    dist_test.assert_equal_trees(tcm.flatten_paths(resumed.state.params), ranks[0]["params"], "resumed params")
    if which == "fused":
        state = tcm.flatten_paths({"mu": resumed.state.mu, "nu": resumed.state.nu})
    else:
        state = tcm.flatten_paths(resumed.state.opt_state)
    assert set(state) == set(ranks[0]["state"])
    state, want = bits(state), bits(ranks[0]["state"])
    for k, v in want.items():
        assert torch.equal(state[k], v) if isinstance(v, torch.Tensor) else state[k] == v, k
    assert (Path(ranks[0]["saved"]) / ckpt.AUX_FILE).exists()


def test_one_rank_pi0fast_save_resumes_at_tensor_2(groups):
    """A one-rank Pi0FAST save (one update) resumed at (1, 1, 2): every
    rank's gathered params and 8-bit optimizer state equal the files, each
    rank holding its tensor slices (the table's vocabulary rows among them)."""
    for res in groups["pair"]:
        got = res["resumed_fast"]
        assert got["params_equal"] and got["state_equal"] and got["cnt_update"] == 1
        assert {"vlm_embed/embedding", "vlm/blocks/attn/q/kernel"} <= set(got["split"])
