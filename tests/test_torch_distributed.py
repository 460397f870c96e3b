"""The port on several ranks: spawned gloo groups on the CPU (tests/test_torch_distributed_ranks.py).

Two groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, and each group is joined within JOIN_TIMEOUT or the
test fails (its processes are killed): nothing here can hang the run.

  * two ranks: process_mean and broadcast_from_host0; GatherLayer alone on a
    bucket of bf16, int8 and fp32 leaves against per-leaf collectives; the
    standard step, ZeRO-3 over fsdp (the rules' leaves held as slices), at
    (data 2, fsdp 1) and (data 1, fsdp 2) against the port's one-rank step on
    the same global batch and against the JAX package's jit_train_step on a
    2-device mesh (tests/test_parallel_train.py), within the JAX tests'
    tolerances: loss rtol 1e-4, params 1e-4 abs. Pi0's joint recipe (8-bit
    AdamW with tiny leaves quantized, an active clip, accumulation 2, SR off)
    and its expert-only recipe (the frozen int8 tower split, AdamW), and at
    fsdp 2 pi0fast_tiny and MVLA's tiny config; every rank on the whole
    batch, params and both moments bit for bit one rank's; each rank's
    param, accumulator and moment elements of a split leaf a half of the
    whole; the fused step with every rank on the whole batch (the reduced
    gradient is then one rank's) at (2, 1) and (1, 2), bf16 with stochastic
    rounding: params and moments bit for bit one rank's; and at data 2 on the
    ranks' own rows (fp32, SR off) against one rank on the whole batch; a
    one-rank checkpoint resumed on two fsdp ranks, one update there (each
    rank on its own rows, and again every rank on the whole batch), saved
    from the ranks and resumed on one rank, against continuing on one rank
    over the same rows;
    each rank's episode shard;
  * four ranks: config/train/pi0_finetune_bridge.yaml (SigLIP at width 30,
    which does not split over 4 and stays whole) and
    config/train/pi0fast_finetune_bridge.yaml at pi0fast_tiny, each with its
    mesh (data -1, fsdp 4) unchanged, through the Trainer.

The flow noise and time are passed in (the JAX step's own draws where JAX
is compared), and the batches carry no padded actions: the ranks average
their micro-batch means, as DDP does, where the JAX program takes one mean
over the global batch, and the two agree when the ranks' rows count alike
(ROADMAP.md, section C).
"""

import dataclasses
import functools
import socket
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_distributed_ranks as child
from intact_tpu.models import common as jcm
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.mvla import model as jmvla
from intact_tpu.models.mvla.config import MVLAConfig as JMVLAConfig
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.models.pi0fast import model as jfast
from intact_tpu.models.pi0fast.config import Pi0FASTConfig as JFASTConfig
from intact_tpu.parallel import MeshConfig as JMeshConfig
from intact_tpu.parallel import batch_sharding, make_mesh as j_make_mesh
from intact_tpu.train import optim8bit as j8
from intact_tpu.train.optim import OptimizerConfig as JOpt
from intact_tpu.train.optim import make_optimizer as j_make_optimizer
from intact_tpu.train.train_step import init_train_state as j_init_state
from intact_tpu.train.train_step import jit_train_step, state_shardings
from intact_tpu.train.train_step import make_train_step as j_make_step
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models.pi0.config import Pi0Config as TPi0Config
from intact_tpu_torch.train import checkpoint as ckpt
from intact_tpu_torch.train import optim8bit as t8
from intact_tpu_torch.train.optim import OptimizerConfig as TOpt
from intact_tpu_torch.train.optim import make_optimizer as t_make_optimizer
from intact_tpu_torch.train.train_step import init_train_state as t_init_state
from intact_tpu_torch.train.train_step import make_train_step as t_make_step

JOIN_TIMEOUT = 120.0  # seconds per group, then the test fails
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
MIN_QUANT = 1024  # 8-bit moments from 1024 elements, so tiny() has some
STD_OPT = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=0, first_cycle_steps=100, max_grad_norm=0.5,
               grad_accumulation_steps=2, quantize_moments=True)
# the expert-only recipe's AdamW. Its eps is 1e-3: at 1e-8 Adam's first step moves an element whose
# gradient lies below the two packages' rounding agreement (8.7e-7 of a leaf whose largest is 0.36 here) by
# +-lr, the sign set by rounding; at 1e-3 the step is continuous in the gradient, so 1e-4 abs holds the
# reductions and not the rounding
EXPERT_OPT = {**STD_OPT, "quantize_moments": False, "eps": 1e-3}
# the clip inactive: a rank's sum of squares over its slices rounds otherwise than one rank's over whole leaves
SAME_OPT = {**STD_OPT, "max_grad_norm": 1e9}
FROZEN = ("siglip", "img_proj", "vlm", "vlm_embed")  # train_expert_only's frozen set
FUSED_OPT = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=0, first_cycle_steps=100, max_grad_norm=1e9)
GLOBAL_ROWS = 4
CKPT_OVERRIDES = {"master_dtype": "float32", "global_batch_size": GLOBAL_ROWS, "n_updates": 2}
SHARD_FRAMES = 48
# the key bias's exact gradient is 0 (softmax is shift-invariant): its gradient
# is rounding noise, which Adam scales to ~lr a step (tests/test_torch_train.py)
STRUCTURALLY_ZERO = {"siglip/blocks/attn/k/bias"}


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


def make_batch(cfg, b: int, rng: np.random.Generator) -> dict:
    s = cfg.vision.image_size
    lang_masks = np.zeros((b, cfg.tokenizer_max_length), bool)
    lang_masks[:, :4] = True
    return {
        "images": rng.uniform(-1, 1, (b, cfg.num_cameras, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, cfg.num_cameras), bool),
        "lang_tokens": rng.integers(0, 256, (b, cfg.tokenizer_max_length)).astype(np.int32),
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, cfg.max_state_dim), dtype=np.float32),
        "actions": rng.standard_normal((b, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32),
    }


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def tiny_pipeline(mp_: pytest.MonkeyPatch, vision=None) -> None:
    """As the ranks run the trainer (test_torch_distributed_ranks.tiny_pipeline), undone with `mp_`."""
    from intact_tpu_torch.config import pipeline

    tiny = TPi0Config.tiny() if vision is None else dataclasses.replace(TPi0Config.tiny(), vision=vision)
    mp_.setattr(t8, "MIN_QUANT_ELEMS", MIN_QUANT)
    mp_.setattr(pipeline, "pi0_config_from_json", lambda d: dataclasses.replace(
        tiny, train_expert_only=bool(d.get("train_expert_only", False))))


def jax_draws(cfg, n_steps: int, shape) -> list:
    """The noise and time jit_train_step's compute_loss draws at each micro-step from seed 0."""
    rng, out = jax.random.key(0), []
    for _ in range(n_steps):
        rng, step_key, _ = jax.random.split(rng, 3)
        k_noise, k_time = jax.random.split(step_key)
        out.append((np.array(jpi0.sample_noise(k_noise, shape)), np.array(jpi0.sample_time(k_time, shape[0], cfg))))
    return out


def std_tasks(rng: np.random.Generator) -> tuple[dict, dict]:
    """The standard-step tasks the ranks run -> (the ranks' inputs {task:
    family, port params (flat), freeze mask, optimizer, two 4-row
    micro-batches, the JAX step's flow draws}, the JAX side {task: (config,
    params, freeze mask, loss)})."""
    ports, jaxes = {}, {}
    pi0_cfg = JPi0Config.tiny()
    pi0_params = jax.jit(jpi0.init, static_argnums=1)(jax.random.key(0), pi0_cfg)
    fast_cfg, mvla_cfg = JFASTConfig.tiny(), JMVLAConfig.tiny()
    for task, fam, jcfg, opt in (("pi0", "pi0", pi0_cfg, STD_OPT), ("pi0_same", "pi0", pi0_cfg, SAME_OPT),
                                 ("expert", "expert", dataclasses.replace(pi0_cfg, train_expert_only=True), EXPERT_OPT),
                                 ("fast", "fast", fast_cfg, STD_OPT), ("mvla", "mvla", mvla_cfg, STD_OPT)):
        module = {"pi0": jpi0, "expert": jpi0, "fast": jfast, "mvla": jmvla}[fam]
        jparams = pi0_params if fam in ("pi0", "expert") else jax.jit(module.init, static_argnums=1)(
            jax.random.key(0), jcfg)
        jmask = None
        if fam == "expert":  # the frozen tower in int8, as quantize_frozen_int8 stores it
            mask = jax.tree.map(lambda _: True, jparams)
            for name in FROZEN:
                mask[name] = jax.tree.map(lambda _: False, jparams[name])
            jparams = jax.jit(lambda p, m=mask: jcm.quantize_frozen(p, m))(jparams)
            jmask = {name: jax.tree.map(lambda _, t=name not in FROZEN: t, sub) for name, sub in jparams.items()}
        batches = [make_batch(jcfg, GLOBAL_ROWS, rng) for _ in range(2)]
        draws = jax_draws(jcfg, 2, batches[0]["actions"].shape) if fam != "fast" else []  # Pi0FAST draws nothing
        tcfg = child.family(fam)[1]
        tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        ports[task] = {"family": fam, "params": tcm.flatten_paths(tparams), "opt": opt,
                       "mask": None if jmask is None else tcm.flatten_paths(
                           {k: tcm.tree_map(lambda _, t=k not in FROZEN: t, v) for k, v in tparams.items()}),
                       "batches": [tensors(b) for b in batches], "noise": [torch.from_numpy(n) for n, _ in draws],
                       "time": [torch.from_numpy(t) for _, t in draws]}
        jaxes[task] = (jcfg, jparams, jmask, lambda p, k, b, m=module, c=jcfg: m.compute_loss(p, k, b, c, J32),
                       batches)
    return ports, jaxes


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn both groups, compute the one-rank and JAX references meanwhile,
    join, and hand the ranks' results with the references to the tests."""
    workdir = tmp_path_factory.mktemp("ranks")
    mp_ = pytest.MonkeyPatch()
    tiny_pipeline(mp_)
    mp_.setattr(j8, "adamw8bit", functools.partial(j8.adamw8bit, min_quant_elems=MIN_QUANT))
    try:
        rng = np.random.default_rng(5)
        std, jaxes = std_tasks(rng)
        fused_batch = make_batch(JPi0Config.tiny(), GLOBAL_ROWS, rng)
        ckpt_batch = make_batch(JPi0Config.tiny(), GLOBAL_ROWS, rng)

        # a one-rank run of the joint recipe, its update-1 checkpoint for the ranks to resume
        from intact_tpu_torch.train.trainer import Trainer

        one = Trainer(child.recipe_config(child.JOINT_RECIPE, **{
            **CKPT_OVERRIDES, "mesh.fsdp": 1, "per_device_batch_size": GLOBAL_ROWS, "n_updates": 1,
            "log_dir": workdir / "one"}), device="cpu")
        one.train()
        inputs = {
            "params": std["pi0"]["params"], "std": std,
            "fused_opt": FUSED_OPT, "fused_batch": tensors(fused_batch),
            "fused_noise": torch.from_numpy(rng.standard_normal(fused_batch["actions"].shape, dtype=np.float32)),
            "fused_time": torch.from_numpy(rng.uniform(0.1, 0.9, GLOBAL_ROWS).astype(np.float32)),
            "fused_salt": 12345, "ckpt_step": str(one.ckpt_root / "step_1"), "ckpt_overrides": CKPT_OVERRIDES,
            "ckpt_batch": tensors(ckpt_batch),
            "ckpt_noise": torch.from_numpy(rng.standard_normal(ckpt_batch["actions"].shape, dtype=np.float32)),
            "ckpt_time": torch.from_numpy(rng.uniform(0.1, 0.9, GLOBAL_ROWS).astype(np.float32)),
            "shard_frames": SHARD_FRAMES,
        }
        torch.save(inputs, workdir / "inputs.pt")
        deadline = time.monotonic() + JOIN_TIMEOUT
        contexts = {"pair": spawn(child.pair, 2, workdir), "quad": spawn(child.quad, 4, workdir)}
        try:
            refs = references(std, jaxes, one, inputs)
        except BaseException:
            for ctx in contexts.values():
                for p in ctx.processes:
                    p.kill()
            raise
        for name, ctx in contexts.items():
            join(ctx, deadline, name)
        return {"workdir": workdir, "refs": refs, "one": one, "inputs": inputs,
                "pair": [torch.load(workdir / f"pair_rank{r}.pt", weights_only=False) for r in range(2)],
                "quad": [torch.load(workdir / f"quad_rank{r}.pt", weights_only=False) for r in range(4)]}
    finally:
        mp_.undo()


# the tasks held against JAX's 2-device step, and on which meshes
JAX_MESHES = {"pi0": ((2, 1), (1, 2)), "expert": ((2, 1), (1, 2)), "fast": ((1, 2),), "mvla": ((1, 2),)}


def references(std: dict, jaxes: dict, one, inputs) -> dict:
    """What the ranks are held to: the port's one-rank standard step and
    JAX's jit_train_step on 2-device meshes over the same two micro-batches,
    the one-rank continuation of the checkpointed run, and one rank's frames."""
    out = {}
    for task, meshes in JAX_MESHES.items():
        spec = std[task]
        model, tcfg = child.family(spec["family"])
        mask = None if spec["mask"] is None else tcm.unflatten_paths(spec["mask"])
        ttx, _ = t_make_optimizer(TOpt(**spec["opt"]), mask)
        tstate = t_init_state(tcm.unflatten_paths({k: v.clone() for k, v in spec["params"].items()}), ttx, seed=0)
        tstep = t_make_step(lambda p, rng, b, n, t, m=model, c=tcfg: m.compute_loss(p, rng, b, c, T32, noise=n,
                                                                                    time=t), ttx)
        losses = []
        for i, batch in enumerate(spec["batches"]):
            draw = dict(noise=spec["noise"][i], time=spec["time"][i]) if spec["noise"] else {}
            tstate, m = tstep(tstate, batch, **draw)
            losses.append(m["l2_loss"].item())
        out[f"port_{task}"] = {"losses": losses, "params": tcm.flatten_paths(tstate.params)}

        jcfg, jparams, jmask, loss_fn, batches = jaxes[task]
        jtx, _ = j_make_optimizer(JOpt(**spec["opt"]), jmask)
        jstep = j_make_step(loss_fn, jtx, J32, trainable_mask=jmask)
        for data, fsdp in meshes:
            mesh = j_make_mesh(JMeshConfig(data=data, fsdp=fsdp, tensor=1), devices=jax.devices()[:2])
            state = j_init_state(jax.tree.map(lambda x: jnp.array(np.asarray(x)), jparams), jtx, seed=0)  # donated
            sh = state_shardings(state, mesh)
            state = jax.device_put(state, sh)
            step = jit_train_step(jstep, mesh, sh, batch_sharding(mesh))
            losses = []
            for batch in batches:
                state, m = step(state, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                                      batch_sharding(mesh)))
                losses.append(float(m["l2_loss"]))
            params = tcm.flatten_paths(jax.tree.map(np.asarray, state.params))
            out[f"jax_{task}_{data}x{fsdp}"] = {"losses": losses, "params": {
                k: np.swapaxes(v, -1, -2) if k.endswith("kernel_q") else np.asarray(v) for k, v in params.items()}}

    out["continued_split"] = continue_on_split_rows(one, inputs)
    one.state, _ = one.train_step(one.state, tensors(inputs["ckpt_batch"]), noise=inputs["ckpt_noise"],
                                  time=inputs["ckpt_time"])
    out["continued"] = {k: v.clone() for k, v in tcm.flatten_paths(one.state.params).items()}

    # one rank's episode stream and where each episode starts in it
    frames, data = [], iter(one.train_data)
    while len(frames) < 4 * SHARD_FRAMES:
        frames += child.frame_keys(next(data))
    lengths = [len(one.train_data._ds.episode(i)["action"]) for i in range(64)]
    out["episodes"] = [frames[sum(lengths[:i]):sum(lengths[:i + 1])] for i in range(64)
                       if sum(lengths[:i + 1]) <= len(frames)]
    return out


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def continue_on_split_rows(one, inputs) -> dict:
    """The checkpointed one-rank run's next update over the rows the two
    ranks take, as two micro-batches of accumulation 2 (rows 0-1, then 2-3):
    the one-rank step whose gradients are the ranks' own. Leaves `one` as it
    was."""
    tx, _ = t_make_optimizer(dataclasses.replace(one.opt_cfg, grad_accumulation_steps=2), one.frozen_mask)
    params = tcm.unflatten_paths({k: v.clone() for k, v in tcm.flatten_paths(one.state.params).items()})
    state = t_init_state(params, tx, seed=one.state.seed)
    state.opt_state.update({k: _clone(one.state.opt_state[k]) for k in ("count", "mu", "nu")})
    step = t_make_step(lambda p, rng, b, n, t: one.model.compute_loss(p, rng, b, one.model_cfg, one.policy,
                                                                      noise=n, time=t), tx)
    batch = tensors(inputs["ckpt_batch"])
    for rows in (slice(0, 2), slice(2, 4)):
        state, _ = step(state, {k: v[rows] for k, v in batch.items()}, noise=inputs["ckpt_noise"][rows],
                        time=inputs["ckpt_time"][rows])
    assert state.opt_state["count"] == one.state.opt_state["count"] + 1
    return {k: v.clone() for k, v in tcm.flatten_paths(state.params).items()}


def assert_params_close(got: dict, want: dict, atol: float, what: str) -> None:
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(np.asarray(v, np.float32), np.asarray(want[k], np.float32), rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


def assert_equal_trees(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k, v in a.items():
        assert v.dtype == b[k].dtype and torch.equal(v, b[k]), f"{what}: {k}"


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_group_and_host_collectives(groups):
    for r, res in enumerate(groups["pair"]):
        assert (res["backend"], res["world"], res["index"]) == ("gloo", 2, r)
        assert res["mean"] == {"loss": 2.0, "acc": 0.5}
        assert res["broadcast"] == [10.0, 10.0, 10.0]


def assert_matches_one_rank_and_jax(groups, task: str, mesh: str) -> None:
    """Two ranks, two micro-steps of 2 rows each (accumulation 2): the mean of
    the ranks' losses per micro-step and the params after the update against
    the one-rank port step on the 4-row micro-batches and JAX's 2-device step."""
    ranks = [res[f"{task if task != 'pi0' else 'std'}_{mesh}"] for res in groups["pair"]]
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    losses = np.mean([r["losses"] for r in ranks], axis=0)
    for ref in (f"port_{task}", f"jax_{task}_{mesh}"):
        want = groups["refs"][ref]
        np.testing.assert_allclose(losses, want["losses"], rtol=1e-4, err_msg=ref)
        assert_params_close({k: v.float().numpy() for k, v in ranks[0]["params"].items()}, want["params"], 1e-4, ref)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_standard_step_matches_one_rank_and_jax(groups, mesh):
    """Pi0's joint recipe: 8-bit AdamW with an active clip; at fsdp 2 ZeRO-3."""
    assert_matches_one_rank_and_jax(groups, "pi0", mesh)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_expert_only_step_matches_one_rank_and_jax(groups, mesh):
    """Pi0's expert-only recipe: the frozen int8 tower (its kernel_q split by
    the rules at fsdp 2 and gathered under no_grad for the W8A8 product), the
    expert's AdamW."""
    assert_matches_one_rank_and_jax(groups, "expert", mesh)
    if mesh == "1x2":
        held = groups["pair"][0]["expert_1x2"]["held"]
        assert any(k.startswith("expert/blocks/") and v is not None for k, v in held.items())


@pytest.mark.parametrize("task", ["fast", "mvla"])
def test_other_families_match_one_rank_and_jax_at_fsdp_2(groups, task):
    """pi0fast_tiny (its tied table split, gathered once per loss) and MVLA's
    tiny config (the expert's self/cross pairs and the connector split) at
    (data 1, fsdp 2)."""
    assert_matches_one_rank_and_jax(groups, task, "1x2")
    held = groups["pair"][0][f"{task}_1x2"]["held"]
    split = [k for k, v in held.items() if v is not None]
    assert split and (task != "fast" or "vlm_embed/embedding" in split)
    assert task != "mvla" or any(k.startswith("expert/pairs/cross/") for k in split)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_standard_step_is_one_ranks_on_the_same_rows(groups, mesh):
    """Every rank on the whole micro-batches (the clip inactive, SR off): the
    reduced gradients are one rank's bit for bit, and so are the params and
    both moments (codes and scales) after the update; grad_norm (a split
    gradient's fsdp mean) and param_norm are one rank's, summed in another
    order."""
    for res in groups["pair"]:
        ranks, one = res[f"same_{mesh}"]["ranks"], res[f"same_{mesh}"]["one"]
        assert ranks["losses"] == one["losses"]
        np.testing.assert_allclose(ranks["norms"], one["norms"], rtol=1e-5)
        assert_equal_trees(ranks["params"], one["params"], "params")
        for name in ("mu", "nu"):
            assert_equal_trees(ranks[name], one[name], name)
        assert any(k.endswith("/q") for k in ranks["mu"])


def test_standard_step_with_no_leaf_to_split(groups):
    """At fsdp 2 under rules that split nothing (every leaf replicated, fp32
    moments), the second rank counts no leaf in the clip's sum: the update
    still matches one rank's on the whole micro-batches."""
    ranks = [res["std_unsplit"]["ranks"] for res in groups["pair"]]
    one = groups["pair"][0]["std_unsplit"]["one"]
    assert all(v is None for v in ranks[0]["held"].values()) and not any(k.endswith("/q") for k in one["mu"])
    coll = ranks[0]["collectives"]
    assert coll["bucket_reduce_scatter"] == coll["bucket_all_gather"] == coll["reduce_scatter"] == 0
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    np.testing.assert_allclose(np.mean([r["losses"] for r in ranks], axis=0), one["losses"], rtol=1e-4)
    assert_params_close({k: v.numpy() for k, v in ranks[0]["params"].items()},
                        {k: v.numpy() for k, v in one["params"].items()}, 1e-4, "unsplit")


def test_standard_step_splits_the_moments_over_fsdp(groups):
    """At fsdp 2 each rank holds half of every split leaf's param, gradient,
    accumulator and moment codes (read from its state and the gradient its
    optimizer is handed) and the scales of all the whole leaf's blocks; the
    gathered moments are one layout for every mesh; the micro-steps and the
    update issue the collectives the code implies."""
    split = [res["std_1x2"] for res in groups["pair"]]
    whole = groups["pair"][0]["std_2x1"]
    assert all(v is None for v in whole["held"].values())
    held = {k: v for k, v in split[0]["held"].items() if v is not None}
    assert held and set(held) == {k for k, v in split[1]["held"].items() if v is not None}
    quantized = 0
    for k, (n, param, acc, codes, scales, grad) in held.items():
        assert param == grad == acc == codes[0] == codes[1] == n // 2, k
        quantized += bool(scales[0])
        assert scales == ([-(-n // t8.BLOCK_SIZE)] * 2 if scales[0] else [0, 0]), k
    assert quantized and set(whole["mu"]) == set(split[0]["mu"])
    for k, m in whole["mu"].items():
        assert m.shape == split[0]["mu"][k].shape, k
    cfg, n_layers = TPi0Config.tiny(), len(held)
    n_replicated = len(whole["params"]) - n_layers
    # per micro-step: a bucket per layer of SigLIP (and its recompute), of each stack of the joint pass (and
    # the recompute of all but the last), the embedding's; a reduce-scatter per bucket that trains; the norms'
    # all-reduce. Per update: a data all-reduce per split leaf, a MAX all-reduce per 8-bit one, a world
    # all-reduce per replicated leaf, one for the clip
    gathers = 2 * cfg.vision.depth + 1 + 2 * (2 * (cfg.vlm.depth - 1) + 1)
    scatters = cfg.vision.depth + 1 + 2 * cfg.vlm.depth
    for res in split:
        assert res["collectives"] == {
            "all_reduce": 2 + n_layers + n_replicated + 1, "all_reduce_max": quantized, "reduce_scatter": 0,
            "all_gather": 0, "bucket_all_gather": 2 * gathers, "bucket_reduce_scatter": 2 * scatters,
            "broadcast": 0}


def test_gather_layer_buckets_mixed_dtypes(groups):
    """One layer of a bf16, an int8 and an fp32 stacked leaf in one bucket, and
    an unstacked leaf alone: one all-gather each, every leaf whole, contiguous
    and 16-byte aligned, equal to its own all-gather; the backward's one
    reduce-scatter per bucket adds each trainable leaf's part into its
    gradient at the layer, equal to a reduce-scatter per leaf, and leaves the
    int8 codes without one."""
    for res in groups["pair"]:
        check = res["gather_layer"]
        for key in ("gather_1", "gather_None"):
            assert check[key] == {"per_leaf": True, "whole": True, "contiguous": True, "aligned": True,
                                  "calls": 1}, key
        assert check["reduce_scatter"] == {"equal": True, "frozen": True, "calls": 2}


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_fused_step_is_one_ranks_where_the_reduced_gradient_is(groups, mesh):
    """Every rank on the whole batch (bf16, stochastic rounding, 8-bit
    moments, the row kernel's plain version at block 8), two steps: params
    and the gathered moments bit for bit one rank's, the loss equal, the grad
    norm summed over the fsdp shards within 1e-6."""
    for res in groups["pair"]:
        ranks, one = res[f"fused_same_{mesh}"]["ranks"], res[f"fused_same_{mesh}"]["one"]
        assert_equal_trees(ranks["params"], one["params"], "params")
        for name in ("mu", "nu"):
            assert_equal_trees(ranks[name], one[name], name)
        for (l1, g1), (l2, g2) in zip(ranks["metrics"], one["metrics"]):
            assert l1 == l2
            np.testing.assert_allclose(g1, g2, rtol=1e-6)
        if mesh == "1x2":
            assert 0 < ranks["local_rows"] < one["local_rows"]


def test_fused_step_on_the_ranks_rows_matches_one_rank(groups):
    """Data 2 on the ranks' own 2 rows (fp32, SR off) against one rank on the
    4-row batch: loss and grad norm rtol 1e-4, params 1e-4 abs, the ranks
    equal to each other."""
    ranks = [res["fused_rows_2x1"]["ranks"] for res in groups["pair"]]
    one = groups["pair"][0]["fused_rows_2x1"]["one"]
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    for step in range(2):
        np.testing.assert_allclose(np.mean([r["metrics"][step][0] for r in ranks]), one["metrics"][step][0], rtol=1e-4)
        np.testing.assert_allclose(ranks[0]["metrics"][step][1], one["metrics"][step][1], rtol=1e-4)
    init = groups["inputs"]["params"]
    for path in STRUCTURALLY_ZERO:
        for params in (ranks[0]["params"], one["params"]):
            assert (params.pop(path) - init[path]).abs().max() <= 2 * 2 * FUSED_OPT["lr"]
    assert_params_close({k: v.numpy() for k, v in ranks[0]["params"].items()},
                        {k: v.numpy() for k, v in one["params"].items()}, 1e-4, "fused")


def resume_ranks_save_on_one_rank(groups, monkeypatch, ranks: list, log_dir: str) -> None:
    """The ranks restored the one-rank save (their gathered state equal to
    the file), each holding its slices; their update, saved from the ranks
    leaf by leaf in the one-rank layout, resumes on one rank with the same
    params, moments and accumulators."""
    from intact_tpu_torch.train.trainer import Trainer

    assert all(r["restored_equal"] for r in ranks)
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    saved = Path(ranks[0]["saved"])
    assert saved.name == "step_2" and (saved / ckpt.AUX_FILE).exists()
    tiny_pipeline(monkeypatch)
    resumed = Trainer(child.recipe_config(child.JOINT_RECIPE, **CKPT_OVERRIDES, **{
        "mesh.fsdp": 1, "per_device_batch_size": GLOBAL_ROWS, "log_dir": groups["workdir"] / log_dir,
        "load_from_checkpoint": saved}), device="cpu")
    assert resumed.cnt_update == 2
    assert_equal_trees(tcm.flatten_paths(resumed.state.params), ranks[0]["params"], "resumed")
    state = tcm.flatten_paths(resumed.state.opt_state)
    assert set(state) == set(ranks[0]["opt_state"])
    for k, v in ranks[0]["opt_state"].items():  # the ranks' gathered moments and accumulators: one rank's layout
        assert torch.equal(state[k], v) if isinstance(v, torch.Tensor) else state[k] == v, k
    assert any(v is not None for v in ranks[0]["held"].values())  # the two ranks held slices
    assert ranks[0]["fields_dropped"] == 0 and ranks[1]["fields_dropped"] > 0  # only process 0 keeps them


def test_checkpoint_resumes_across_world_sizes(groups, monkeypatch):
    """A one-rank save resumes on two fsdp ranks; their next update, each
    rank on its own 2 of the 4 rows, saved from the ranks, resumes on one
    rank, and equals one rank continuing over the same 2 + 2 rows
    (accumulation 2). That split, not the ranks, is why both sit 4.5e-4
    from one rank continuing on the 4 rows at once in one element of
    expert/blocks/mlp/down/kernel (the one-rank run over 2 + 2 rows moves it
    as far, and the ranks' params equal it): bf16 compute rounds the
    gradient of 2 + 2 rows otherwise than that of 4."""
    ranks = [res["ckpt"] for res in groups["pair"]]
    resume_ranks_save_on_one_rank(groups, monkeypatch, ranks, "three")
    assert_params_close({k: v.float().numpy() for k, v in ranks[0]["params"].items()},
                        {k: v.float().numpy() for k, v in groups["refs"]["continued_split"].items()}, 1e-4,
                        "continued over the same split")


def test_checkpoint_resumes_from_ranks_on_the_same_rows(groups, monkeypatch):
    """As above with every rank on the whole 4-row batch (the reduced
    gradient is one rank's): against one rank continuing on the 4 rows."""
    ranks = [res["ckpt_same"] for res in groups["pair"]]
    resume_ranks_save_on_one_rank(groups, monkeypatch, ranks, "three_same")
    assert_params_close({k: v.float().numpy() for k, v in ranks[0]["params"].items()},
                        {k: v.float().numpy() for k, v in groups["refs"]["continued"].items()}, 1e-4, "continued")


def test_each_rank_reads_its_own_episodes(groups):
    """Rank r of 2 reads episodes r, r + 2, ...: disjoint shards whose union
    is one rank's episodes."""
    episodes = groups["refs"]["episodes"]
    shards = [res["ckpt"]["frames"] for res in groups["pair"]]
    assert len(shards[0]) == len(shards[1]) == SHARD_FRAMES and not set(shards[0]) & set(shards[1])
    for r, frames in enumerate(shards):
        want = [f for e in episodes[r::2] for f in e]
        assert len(want) >= len(frames) and frames == want[:len(frames)], r
    covered = set(shards[0]) | set(shards[1])
    complete = [i for i, e in enumerate(episodes) if set(e) <= covered]
    assert len(complete) >= 2 and complete == list(range(len(complete)))  # one rank's first episodes


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def check_recipe_on_four_ranks(groups, monkeypatch, name: str, recipe, extra: dict, vision=None) -> dict:
    """The recipe's mesh (data -1, fsdp 4) resolves to 1 x 4 x 1 at world 4:
    one update of 2 rows per rank (global 8), the ranks' params bit-equal
    after it, each holding a quarter of every split leaf's param, gradient,
    accumulator and moments, the validation metrics (sampled through the gathered layers)
    averaged over the ranks, the last update saved from the ranks and
    restored on one rank. -> the ranks' held sizes."""
    from intact_tpu_torch.train.trainer import Trainer

    quad = [res[name] for res in groups["quad"]]
    for res in quad:
        assert res["mesh"] == {"data": 1, "fsdp": 4, "tensor": 1} and res["accum"] == 1
        assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
        assert_equal_trees(res["params"], quad[0]["params"], "ranks' params")
        assert res["validations"] == quad[0]["validations"] and len(res["validations"]) == 1
        assert np.isfinite(res["validations"][0]["l1_loss"])
        coll = res["collectives"]
        assert min(coll[k] for k in ("all_reduce", "bucket_all_gather", "bucket_reduce_scatter")) > 0
        assert coll["broadcast"] == coll["reduce_scatter"] == coll["all_gather"] == 0  # the bucket's own
        held = {k: v for k, v in res["held"].items() if v is not None}  # no accumulator at accumulation 1
        assert held and all(v[1] == v[5] == v[3][0] == v[3][1] == v[0] // 4 and v[2] == 0 for v in held.values())
    step = Path(quad[0]["ckpt_root"]) / "step_1"
    assert (step / ckpt.AUX_FILE).exists()
    tiny_pipeline(monkeypatch, vision)
    resumed = Trainer(child.recipe_config(recipe, **{
        "mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 2, "log_dir": groups["workdir"] / name,
        "load_from_checkpoint": step, **extra}), device="cpu")
    assert_equal_trees(tcm.flatten_paths(resumed.state.params), quad[0]["params"], "resumed on one rank")
    return quad[0]["held"]


def test_repo_recipe_at_its_mesh_on_four_ranks(groups, monkeypatch):
    """pi0_finetune_bridge.yaml; its SigLIP at width 30, which the rules'
    split does not divide over 4: those leaves stay whole on every rank."""
    held = check_recipe_on_four_ranks(groups, monkeypatch, "pi0", child.JOINT_RECIPE, {}, child.quad_vision())
    siglip = {k: v for k, v in held.items() if k.startswith("siglip/blocks/") and k.endswith("/kernel")}
    assert siglip and all(v is None for v in siglip.values())  # the rules name them; 30 does not split over 4
    assert held["vlm/blocks/attn/q/kernel"] is not None


def test_pi0fast_recipe_at_its_mesh_on_four_ranks(groups, monkeypatch):
    """pi0fast_finetune_bridge.yaml at pi0fast_tiny: the tied table trains as
    a quarter on each rank."""
    held = check_recipe_on_four_ranks(groups, monkeypatch, "fast", child.FAST_RECIPE,
                                      {"model_cfg.type": "pi0fast_tiny"})
    assert held["vlm_embed/embedding"] is not None


def test_one_rank_trainer_has_no_group(groups):
    one = groups["one"]
    assert one.mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1} and one.main_rank and not one.mesh.distributed

