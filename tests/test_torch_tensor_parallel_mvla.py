"""The tensor axis for MVLA (the self/cross expert, the joint mmmvla expert and
the DiT head): spawned gloo groups on the CPU
(tests/test_torch_tensor_parallel_mvla_ranks.py).

Two groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, each joined within JOIN_TIMEOUT or the test fails
(its processes are killed):

  * two ranks, mesh (1, 1, 2): every case, the standard step's full and
    expert-only recipes, and the server role's int8 mvla_tiny wrapper;
  * four ranks: every case at (1, 1, 4) (the tiny towers' 2 heads and the
    one K/V head stay whole: the connector's 4 heads, SigLIP's 4 and every
    MLP split) and at (1, 2, 2) (the tensor slices split further over fsdp,
    two batch coordinates of two rows), both recipes at (1, 2, 2).

A case is MVLAConfig.tiny() with a 4-head connector, as "mvla" (self/cross
expert), "mmmvla" (joint expert) or "dit" (the DiT head, its zero-initialised
modulation and output drawn at random so every block reaches the actions),
on parameters made by the JAX `init` and carried across by convert.py, four
rows with ragged language. Held, in fp32 compute: every rank's prompt and
actions (sample_actions on the given noise; the DiT head's DDIM from x_T =
that noise) within 1e-4 relative L2 (tests/test_torch_mvla.py's tolerance)
of `jax.jit` of the JAX package's single-device functions on its rows; in
int8, bit-equal to the port on one rank (one thread, as the ranks run). The
standard step is held as tests/test_torch_tensor_parallel.py holds Pi0's:
loss, grad_norm and the updated params within 1e-4 of `jax.jit` of the JAX
single-device step over the same two micro-batches and draws.
"""

import dataclasses
import functools
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_distributed as dist_test
import test_torch_tensor_parallel as tp_test
import test_torch_tensor_parallel_mvla_ranks as child
from intact_tpu.models import common as jcm
from intact_tpu.models import diffusion as jdiff
from intact_tpu.models import dit as jdit
from intact_tpu.models.mvla import expert as jexpert
from intact_tpu.models.mvla import model as jmvla
from intact_tpu.models.mvla.config import MVLAConfig as JCfg
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.train import optim8bit as j8
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import make_optimizer as j_make_optimizer
from intact_tpu.train.train_step import init_train_state as j_init_state
from intact_tpu.train.train_step import make_train_step as j_make_step
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm

JOIN_TIMEOUT = dist_test.JOIN_TIMEOUT
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
RTOL = 1e-4
ROWS = 4
REFERENCE_THREADS = 3
FROZEN = dist_test.FROZEN  # train_expert_only's frozen set
# the full recipe's 8-bit AdamW (an active clip, accumulation 2) at eps 1e-3, as the expert-only recipe's and
# tests/test_torch_tensor_parallel.py's 4-head Pi0: at 1e-8 Adam's first step moves an element whose gradient
# lies below the two packages' rounding agreement by +-lr, the sign set by rounding (MVLA's tiny SigLIP MLP and
# VLM K/V, 1.6e-4 to 6e-4 from the JAX step on one rank without a group as on the ranks)
FULL_OPT = {**dist_test.STD_OPT, "eps": 1e-3}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_config(case: str, expert_only: bool = False) -> JCfg:
    cfg = JCfg.tiny()
    cfg = dataclasses.replace(cfg, connector=dataclasses.replace(cfg.connector, num_heads=child.CONNECTOR_HEADS),
                              train_expert_only=expert_only)
    if case == "mmmvla":
        return dataclasses.replace(cfg, alternate_pattern="joint")
    return dataclasses.replace(cfg, **child.DIT) if case == "dit" else cfg


def jax_params(case: str, jcfg, base: dict) -> dict:
    """A case's parameters (numpy) from the JAX "mvla" init `base`: its
    prefix, connector and glue, with the joint expert of `init_joint` or the
    DiT of `dit.init` in place of the self/cross expert (the DiT's all-zero
    adaLN and output leaves drawn at random, so that every block reaches the
    actions)."""
    if case == "mvla":
        return base
    head = ("siglip", "img_proj", "vlm_embed", "vlm", "metaquery", "connector")
    if case == "mmmvla":
        expert = jax.jit(jexpert.init_joint, static_argnums=1)(jax.random.key(4), jcfg.expert)
        return {**base, "expert": jax.tree.map(np.asarray, expert)}
    dit = jax.tree.map(np.asarray, jax.jit(jdit.init, static_argnums=1)(jax.random.key(4), jmvla._dit_config(jcfg)))
    rng = np.random.default_rng(8)
    dit = tcm.unflatten_paths({k: rng.standard_normal(v.shape).astype(np.float32) * 0.05 if not np.any(v) else v
                               for k, v in tcm.flatten_paths(dit).items()})
    return {**{k: base[k] for k in head}, "dit": dit}


def case_inputs(cfg, rng: np.random.Generator) -> dict:
    s = cfg.vision.image_size
    lang_masks = np.arange(cfg.tokenizer_max_length)[None] < np.array([8, 5, 3, 6])[:, None]
    return {"images": rng.uniform(-1, 1, (ROWS, cfg.num_cameras, s, s, 3)).astype(np.float32),
            "img_masks": np.ones((ROWS, cfg.num_cameras), bool),
            "lang_tokens": rng.integers(0, 200, (ROWS, cfg.tokenizer_max_length)).astype(np.int32),
            "lang_masks": lang_masks,
            "state": rng.standard_normal((ROWS, cfg.max_state_dim), dtype=np.float32),
            "noise": rng.standard_normal((ROWS, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32)}


def jax_reference(jcfg, jparams, inputs: dict) -> dict:
    """jax.jit of the JAX single-device compute_prompt and sample_actions on
    the given noise (the DiT head: ddim_sample from x_T = the noise, as
    tests/test_torch_mvla.py holds it)."""
    args = [inputs[k] for k in child.INPUTS]
    prompt = jax.jit(lambda p, *a: jmvla.compute_prompt(p, *a, jcfg, J32))(jparams, *args[:4])
    if jcfg.action_head == "dit":
        actions = jax.jit(lambda p, c, x: jdiff.ddim_sample(
            jdiff.make_schedule(jcfg.diffusion_steps), jmvla._dit_eps_fn(p, jcfg, J32), jax.random.key(0), x.shape,
            c, num_steps=jcfg.num_steps, init_noise=x))(jparams, prompt.mean(axis=1), inputs["noise"])
    else:
        actions = jax.jit(lambda p, *a, noise: jmvla.sample_actions(p, jax.random.key(0), *a, jcfg, J32,
                                                                    noise=noise))(jparams, *args,
                                                                                  noise=inputs["noise"])
    return {"prompt": np.asarray(prompt), "actions": np.asarray(actions)}


def one_rank(fn, *args):
    """fn on one thread, as the ranks run (a float product's summation order
    follows the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def std_tasks(jparams: dict, rng: np.random.Generator) -> tuple[dict, dict]:
    """(the ranks' inputs {recipe: ...}, the JAX references' jobs {name:
    function}) of the full and the expert-only recipe on the "mvla" case's
    parameters (numpy) and the same micro-batches and draws: each recipe's
    step (its losses, norms and params) and the per-coordinate gradients.
    The expert-only loss is the full recipe's computation (the metaqueries
    train through the frozen VLM), so its per-coordinate gradients are the
    full recipe's trainable ones (`std_references`)."""
    jcfg = jax_config("mvla")
    masks = {"full": None,
             "expert": {k: jax.tree.map(lambda _, t=k not in FROZEN: t, v) for k, v in jparams.items()}}
    opts = {"full": FULL_OPT, "expert": dist_test.EXPERT_OPT}
    batches = [dist_test.make_batch(jcfg, ROWS, rng) for _ in range(2)]
    draws = dist_test.jax_draws(jcfg, 2, batches[0]["actions"].shape)
    flat = tcm.flatten_paths(convert.from_jax_params(jax.tree.map(np.asarray, jparams), child.config("mvla"),
                                                     device="cpu"))
    common = {"params": flat, "batches": [dist_test.tensors(b) for b in batches],
              "noise": [torch.from_numpy(n) for n, _ in draws], "time": [torch.from_numpy(t) for _, t in draws]}
    ports = {"full": {**common, "opt": opts["full"], "mask": None},
             "expert": {**common, "opt": opts["expert"],
                        "mask": {k: not k.startswith(tuple(f"{f}/" for f in FROZEN)) for k in flat}}}

    def step_of(recipe: str):
        def run() -> dict:
            cfg, jmask = jax_config("mvla", recipe == "expert"), masks[recipe]
            jtx, _ = j_make_optimizer(JOpt(**opts[recipe]), jmask)
            step = jax.jit(j_make_step(lambda p, k, b: jmvla.compute_loss(p, k, b, cfg, J32), jtx, J32,
                                       trainable_mask=jmask))
            state = j_init_state(jax.tree.map(jnp.asarray, jparams), jtx, seed=0)
            losses, norms = [], []
            for batch in batches:
                state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
                losses.append(float(m["l2_loss"]))
                norms.append([float(m["grad_norm"]), float(m["param_norm"])])
            return {"losses": losses, "norms": norms,
                    "params": tcm.flatten_paths(jax.tree.map(np.asarray, state.params)),
                    "trainable": ports[recipe]["mask"] or dict.fromkeys(flat, True)}

        return run

    jobs = {"full": step_of("full"), "expert": step_of("expert"),
            "coordinates": lambda: coordinate_grads(jcfg, jparams, batches, draws, 2)}
    return ports, jobs


def std_references(done: dict) -> dict:
    """Each recipe's reference from the finished jobs: its step's numbers
    and the per-coordinate gradients of its trainable leaves."""
    out = {}
    for recipe in ("full", "expert"):
        ref = dict(done[recipe])
        trainable = ref.pop("trainable")
        ref["coordinates"] = {2: [[{k: g for k, g in c.items() if trainable[k]} for c in micro]
                                  for micro in done["coordinates"]]}
        out[recipe] = ref
    return out


def coordinate_grads(jcfg, jparams, batches: list, draws: list, parts: int) -> list:
    """[micro-step][coordinate] {path: gradient} of every leaf: the JAX
    loss's gradient over one of `parts` batch coordinates' rows with the JAX
    step's draws for those rows, at the initial params (accumulation 2: both
    micro-steps come before the update)."""
    flat = tcm.flatten_paths(jax.tree.map(jnp.asarray, jparams))

    def loss(train, batch, noise, time_):
        saved = jpi0.sample_noise, jpi0.sample_time
        jpi0.sample_noise, jpi0.sample_time = (lambda key, shape: noise), (lambda key, b, cfg: time_)
        try:  # traced once, with the given draws in place of the step's
            return jmvla.compute_loss(tcm.unflatten_paths({**flat, **train}), jax.random.key(0), batch, jcfg, J32)[0]
        finally:
            jpi0.sample_noise, jpi0.sample_time = saved

    grad = jax.jit(jax.grad(loss))
    per = ROWS // parts
    return [[{k: np.asarray(g) for k, g in grad(flat,
                                                 *[jax.tree.map(lambda x: jnp.asarray(x[c * per:(c + 1) * per]), a)
                                                   for a in (batch, noise, time_)]).items()}
             for c in range(parts)] for batch, (noise, time_) in zip(batches, draws)]


def wrapper_inputs(rng: np.random.Generator) -> dict:
    cfg = child.serve_child.server_config("mvla_tiny").make_model_config()
    size = child.serve_child.IMAGE
    return {"wrapper_batch": {"image": rng.integers(0, 256, (ROWS, size, size, 3), dtype=np.uint8),
                              "state": rng.normal(size=(ROWS, 7)).astype(np.float32),
                              "task": [f"put object {i} on the plate" for i in range(ROWS)]},
            "wrapper_noise": torch.from_numpy(rng.standard_normal((ROWS, cfg.chunk_size, cfg.max_action_dim),
                                                                  dtype=np.float32))}


def one_rank_wrapper(inputs: dict) -> np.ndarray:
    wrapper = child.serve_child.pi0_wrapper(inputs, None, quantize=True, model_type="mvla_tiny")
    child.serve_child.fixed_noise(wrapper, inputs["wrapper_noise"])
    wrapper.policy._sample_rows = functools.partial(wrapper.policy._sample_rows, noise=inputs["wrapper_noise"])
    return wrapper.sample_action_chunk(inputs["wrapper_batch"])


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Write the cases, spawn the two groups, compute the JAX and one-rank
    references meanwhile, join, and hand everything to the tests."""
    workdir = tmp_path_factory.mktemp("tensor_mvla_ranks")
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(j8, "adamw8bit", functools.partial(j8.adamw8bit, min_quant_elems=dist_test.MIN_QUANT))
    try:
        rng = np.random.default_rng(19)
        base = jax.tree.map(np.asarray, jax.jit(jmvla.init, static_argnums=1)(jax.random.key(3), jax_config("mvla")))
        specs, jobs = {}, {}
        for case in child.CASES:
            jcfg = jax_config(case)
            jparams = jax_params(case, jcfg, base)
            inputs = case_inputs(jcfg, rng)
            params = convert.from_jax_params(jparams, child.config(case), device="cpu")
            specs[case] = {"case": case, "params": tcm.flatten_paths(params),
                           "inputs": {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}}
            jobs[case] = functools.partial(jax_reference, jcfg, jax.tree.map(jnp.asarray, jparams), inputs)
        std, std_jobs = std_tasks(base, rng)
        inputs = {"cases": specs, "std": std, "min_quant": dist_test.MIN_QUANT, **wrapper_inputs(rng)}
        torch.save(inputs, workdir / "inputs.pt")
        deadline = time.monotonic() + JOIN_TIMEOUT
        contexts = {"pair": dist_test.spawn(child.pair, 2, workdir), "quad": dist_test.spawn(child.quad, 4, workdir)}
        try:
            # the JAX references compile in threads of their own (XLA's compiler runs without the GIL); the
            # per-coordinate gradients, traced with the draws patched into the JAX Pi0 module, before any step's
            with ThreadPoolExecutor(REFERENCE_THREADS) as pool:
                running = {k: pool.submit(fn) for k, fn in jobs.items()}
                done = {"coordinates": std_jobs.pop("coordinates")()}
                running.update({k: pool.submit(fn) for k, fn in std_jobs.items()})
                refs = {case: {"int8": one_rank(child.sample, specs[case], None, True)} for case in child.CASES}
                refs["wrapper"] = one_rank(one_rank_wrapper, inputs)
                done.update({k: f.result() for k, f in running.items()})
            for case in child.CASES:
                refs[case]["jax"] = done[case]
            refs.update(std_references(done))
        except BaseException:
            for ctx in contexts.values():
                for p in ctx.processes:
                    p.kill()
            raise
        for name, ctx in contexts.items():
            dist_test.join(ctx, deadline, name)
        return {"refs": refs, "inputs": inputs,
                **{name: [torch.load(workdir / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]
                   for name, world in (("pair", 2), ("quad", 4))}}
    finally:
        mp_.undo()


MESHES = [("pair", "cases", (1, 1, 2)), ("quad", "1x1x4", (1, 1, 4)), ("quad", "1x2x2", (1, 2, 2))]
GRID = [(g, k, m, c) for g, k, m in MESHES for c in child.CASES]
IDS = [f"{'x'.join(map(str, m))}-{c}" for _, _, m, c in GRID]


def rows_of(rank: dict, mesh: tuple) -> slice:
    per = ROWS // (mesh[0] * mesh[1])
    return slice(rank["batch_index"] * per, (rank["batch_index"] + 1) * per)


@pytest.mark.parametrize("group,key,mesh,case", GRID, ids=IDS)
def test_fp32_sampling_matches_jax_single_device(groups, group, key, mesh, case):
    """Every rank's prompt and actions within 1e-4 relative L2 of the JAX
    package's compiled single-device functions on its rows; the tensor
    ranks of one batch coordinate hold the same."""
    ranks = [res[key][case] for res in groups[group]]
    ref = groups["refs"][case]["jax"]
    for r in ranks:
        rows = rows_of(r, mesh)
        got = r["fp32"]
        assert got["actions"].shape == ref["actions"][rows].shape and torch.isfinite(got["actions"]).all()
        assert rel(got["prompt"].numpy(), ref["prompt"][rows]) <= RTOL
        assert rel(got["actions"].numpy(), ref["actions"][rows]) <= RTOL
        peer = next(o for o in ranks if o["batch_index"] == r["batch_index"])
        assert torch.equal(got["actions"], peer["fp32"]["actions"])


@pytest.mark.parametrize("group,key,mesh,case", GRID, ids=IDS)
def test_int8_sampling_is_one_ranks_bit_for_bit(groups, group, key, mesh, case):
    """int8: every rank's prompt and actions bit-equal to the port's on one
    rank (the column-parallel W8A8 products exact per column, the
    row-parallel ones summed as int32 partials against the whole row's
    absmax, the cross attention at one card's shapes); the row-parallel
    products ran (MAX and sum all-reduces over tensor) and nothing was
    all-gathered over tensor."""
    ranks = [res[key][case] for res in groups[group]]
    ref = groups["refs"][case]["int8"]
    for r in ranks:
        rows = rows_of(r, mesh)
        assert torch.equal(r["int8"]["prompt"], ref["prompt"][rows])
        assert torch.equal(r["int8"]["actions"], ref["actions"][rows])
    counts = ranks[0]["int8"]["collectives"]
    assert counts["tensor_all_reduce"] > 0 and counts["tensor_all_reduce_max"] > 0 and counts["tensor_all_gather"] == 0


# the leaves a case holds as tensor slices at t = 2 (beside SigLIP's, the VLM's and the embedding's, as Pi0's)
SPLIT = {
    "mvla": {"connector/blocks/attn/q/kernel", "connector/blocks/attn/k/kernel", "connector/blocks/attn/o/kernel",
             "connector/blocks/mlp/down/kernel", "expert/pairs/self/attn/q/kernel", "expert/pairs/cross/attn/q/kernel",
             "expert/pairs/cross/attn/o/kernel", "expert/pairs/cross/mlp/gate/kernel", "vlm/blocks/attn/q/kernel"},
    "mmmvla": {"connector/blocks/attn/v/kernel", "expert/blocks/attn/q/kernel", "expert/blocks/mlp/up/kernel"},
    "dit": {"connector/blocks/attn/q/kernel", "dit/blocks/attn/q/kernel", "dit/blocks/attn/v/kernel",
            "dit/blocks/attn/o/kernel", "dit/blocks/mlp/fc1/kernel", "dit/blocks/mlp/fc1/bias",
            "dit/blocks/mlp/fc2/kernel"},
}
# whole on every tensor rank: the one-head K/V kernels, the glue, the norms, the modulation
WHOLE = {"expert/pairs/cross/attn/k/kernel", "expert/pairs/self/attn/v/kernel", "connector/in_proj/kernel",
         "connector/out_proj/kernel", "connector/blocks/attn/q_norm/scale", "dit/blocks/ada/kernel",
         "dit/final/proj/kernel", "dit/blocks/attn/q/bias", "metaquery", "expert/blocks/attn/k/kernel"}


@pytest.mark.parametrize("case", child.CASES)
def test_tensor_slices_follow_the_rules(groups, case):
    """At t = 2 the connector, the expert's self/cross (or joint) layers and
    the DiT split their query heads and MLPs, the one-head K/V kernels, the
    glue, the norms and the DiT's modulation stay whole; at t = 4 (the tiny
    towers' 2 heads) only the connector's 4 heads, SigLIP's 4 and the MLPs
    split, the DiT's 2 heads whole and its MLP split; the int8 tree splits
    its codes alike."""
    pair = set(groups["pair"][0]["cases"][case]["fp32"]["split"])
    assert SPLIT[case] <= pair and not WHOLE & pair
    int8 = set(groups["pair"][0]["cases"][case]["int8"]["split"])
    assert {p.replace("/kernel", "/kernel_q") for p in SPLIT[case] if p.endswith("kernel")} <= int8
    quad = set(groups["quad"][0]["1x1x4"][case]["fp32"]["split"])
    assert {"connector/blocks/attn/q/kernel", "siglip/blocks/attn/q/kernel", "vlm/blocks/mlp/gate/kernel"} <= quad
    assert not {p for p in quad if "/attn/" in p and not p.startswith(("connector", "siglip"))}
    if case == "dit":
        assert {"dit/blocks/mlp/fc1/kernel", "dit/blocks/mlp/fc2/kernel"} <= quad


RECIPES = [("pair", "full", (1, 1, 2), "full"), ("pair", "expert", (1, 1, 2), "expert"),
           ("quad", "full_1x2x2", (1, 2, 2), "full"), ("quad", "expert_1x2x2", (1, 2, 2), "expert")]
# the leaves replicated over tensor whose gradient a rank holds in part, summed over tensor by the step
PARTIAL = {"expert/pairs/self/attn/k/kernel", "expert/pairs/self/attn/v/kernel", "expert/pairs/cross/attn/k/kernel",
           "expert/pairs/cross/attn/v/kernel", "connector/blocks/attn/q_norm/scale",
           "connector/blocks/attn/k_norm/scale"}
PARTIAL_TOWER = {"siglip/blocks/attn/q/bias", "siglip/blocks/attn/k/bias", "siglip/blocks/attn/v/bias",
                 "vlm/blocks/attn/k/kernel", "vlm/blocks/attn/v/kernel"}


@pytest.mark.parametrize("group,key,mesh,recipe", RECIPES, ids=[f"{r}-{'x'.join(map(str, m))}"
                                                                 for _, _, m, r in RECIPES])
def test_standard_step_matches_jax_single_device(groups, group, key, mesh, recipe):
    """MVLA's standard step (full tower with 8-bit AdamW and an active clip;
    train_expert_only with AdamW) against jax.jit of the single-device step:
    per micro-step the losses, grad_norm (at two batch coordinates against
    the JAX gradients over each one's rows) and param_norm, and the params
    after the update; the expert's K/V kernels and the connector's q/k norm
    scales summed over tensor (and the towers' where they train)."""
    ranks = [res[key] for res in groups[group]]
    tp_test.assert_step(ranks, groups["refs"][recipe], mesh)
    want = PARTIAL | (PARTIAL_TOWER if recipe == "full" else set())
    assert set(ranks[0]["partial"]) == want
    assert {"connector/blocks/attn/q/kernel", "expert/pairs/cross/attn/q/kernel"} <= set(ranks[0]["split"])
    coll = ranks[0]["collectives"]
    assert coll["tensor_all_reduce"] > 0 and coll["tensor_all_gather"] == 0
    assert (coll["bucket_all_gather"] > 0) == (mesh[1] > 1)


def test_wrapper_at_1x1x2_is_one_ranks(groups):
    """The server role's int8 mvla_tiny wrapper over (1, 1, 2): rank 0's
    actions on the given noise equal the one-rank wrapper's bit for bit,
    both ranks holding their tensor slices."""
    lead, other = (res["wrapper"] for res in groups["pair"])
    np.testing.assert_array_equal(lead["actions"][0], groups["refs"]["wrapper"])
    assert other["actions"] is None
    for r in (lead, other):
        assert {"connector/blocks/attn/q/kernel_q", "expert/pairs/self/mlp/down/kernel_q"} <= set(r["split"])


def test_rules_split_mvla_at_head_granularity():
    """At the full width: the connector's 8 heads split at tensor 2 and 4;
    the cross layers' one K/V head stays whole; the DiT's 6 heads split at 2
    and stay whole at 4 (its MLP splits at both), where the JAX package's
    rules split its projections by their width; partial_paths names the
    expert pairs' K/V kernels and the connector's q/k norms where q splits."""
    from intact_tpu_torch.models.mvla import model as tmvla
    from intact_tpu_torch.models.mvla.config import MVLAConfig
    from intact_tpu_torch.parallel import sharding, tensor
    from intact_tpu_torch.parallel.mesh import Mesh
    from intact_tpu_torch.parallel.sharding import Sharded

    def spec(path, shape, t, heads):
        mesh = Mesh(1, 1, t, 0, dict.fromkeys(("data", "fsdp", "tensor", "batch", "model", "world")))
        return sharding.spec_for_path(path, shape, mesh, heads=heads)

    cfg = dataclasses.replace(MVLAConfig(), action_head="dit")
    heads = tmvla.tensor_heads(cfg)
    assert heads["connector"] == (8, 8) and heads["dit"] == (6, 6) and heads["expert"] == (8, 1)
    for t in (2, 4):
        assert spec("connector/blocks/attn/q/kernel", (12, 1024, 1024), t, heads) == (None, "fsdp", "tensor")
        assert spec("connector/blocks/attn/o/kernel_q", (12, 1024, 1024), t, heads) == (None, "fsdp", "tensor")
        assert spec("connector/blocks/mlp/down/kernel", (12, 4096, 1024), t, heads) == (None, "tensor", "fsdp")
        assert spec("connector/blocks/attn/q_norm/scale", (12, 128), t, heads) == (None, None)
        assert spec("expert/pairs/cross/attn/k/kernel", (9, 1024, 256), t, heads) == (None, "fsdp", None)
        assert spec("expert/pairs/cross/attn/q/kernel", (9, 1024, 2048), t, heads) == (None, "fsdp", "tensor")
        assert spec("expert/pairs/self/attn/v/kernel_q", (9, 256, 1024), t, heads) == (None, None, "fsdp")
        split = "tensor" if t == 2 else None
        assert spec("dit/blocks/attn/q/kernel", (12, 384, 384), t, heads) == (None, "fsdp", split)
        assert spec("dit/blocks/attn/o/kernel", (12, 384, 384), t, heads) == (None, split, "fsdp")
        assert spec("dit/blocks/mlp/fc1/kernel", (12, 384, 1536), t, heads) == (None, "fsdp", "tensor")
        assert spec("dit/blocks/ada/kernel", (12, 384, 2304), t, heads) == (None, None, None)
    q = Sharded(torch.zeros(1), 0, (1,), None, 1, tensor=sharding.TensorSplit(2, 2, 0, None, (1,)))
    flat = {"expert/pairs/self/attn/q/kernel": q, "expert/pairs/self/attn/k/kernel": 0,
            "expert/pairs/cross/attn/v/kernel_q": 0, "connector/blocks/attn/q/kernel": q,
            "connector/blocks/attn/q_norm/scale": 0, "connector/blocks/attn/k_norm/scale": 0,
            "dit/blocks/attn/k/bias": 0}
    assert tensor.partial_paths(flat) == {"expert/pairs/self/attn/k/kernel", "connector/blocks/attn/q_norm/scale"}
