"""The port on several ranks: spawned gloo groups on the CPU (tests/test_torch_distributed_ranks.py).

Two groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, and each group is joined within JOIN_TIMEOUT or the
test fails (its processes are killed): nothing here can hang the run.

  * two ranks: process_mean and broadcast_from_host0; the standard step (8-bit
    AdamW with tiny leaves quantized, an active clip, accumulation 2, SR off)
    at (data 2, fsdp 1) and (data 1, fsdp 2) against the port's one-rank step
    on the same global batch and against the JAX package's jit_train_step on
    a 2-device mesh (tests/test_parallel_train.py), within the JAX tests'
    tolerances: loss rtol 1e-4, params 1e-4 abs; the fused step with every
    rank on the whole batch (the reduced gradient is then one rank's) at
    (2, 1) and (1, 2), bf16 with stochastic rounding: params and moments bit
    for bit one rank's; and at data 2 on the ranks' own rows (fp32, SR off)
    against one rank on the whole batch; a one-rank checkpoint resumed on two
    fsdp ranks, one update there, saved from the ranks and resumed on one
    rank, against continuing on one rank; each rank's episode shard;
  * four ranks: config/train/pi0_finetune_bridge.yaml with its mesh
    (data -1, fsdp 4) unchanged, through the Trainer.

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
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
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
from intact_tpu_torch.models.pi0 import model as tpi0
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


def tiny_pipeline(mp_: pytest.MonkeyPatch) -> None:
    """As the ranks run the trainer (test_torch_distributed_ranks.tiny_pipeline), undone with `mp_`."""
    from intact_tpu_torch.config import pipeline

    mp_.setattr(t8, "MIN_QUANT_ELEMS", MIN_QUANT)
    mp_.setattr(pipeline, "pi0_config_from_json", lambda d: dataclasses.replace(
        TPi0Config.tiny(), train_expert_only=bool(d.get("train_expert_only", False))))


def jax_draws(cfg, n_steps: int, shape) -> list:
    """The noise and time jit_train_step's compute_loss draws at each micro-step from seed 0."""
    rng, out = jax.random.key(0), []
    for _ in range(n_steps):
        rng, step_key, _ = jax.random.split(rng, 3)
        k_noise, k_time = jax.random.split(step_key)
        out.append((np.array(jpi0.sample_noise(k_noise, shape)), np.array(jpi0.sample_time(k_time, shape[0], cfg))))
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Spawn both groups, compute the one-rank and JAX references meanwhile,
    join, and hand the ranks' results with the references to the tests."""
    workdir = tmp_path_factory.mktemp("ranks")
    mp_ = pytest.MonkeyPatch()
    tiny_pipeline(mp_)
    mp_.setattr(j8, "adamw8bit", functools.partial(j8.adamw8bit, min_quant_elems=MIN_QUANT))
    try:
        jcfg, tcfg = JPi0Config.tiny(), TPi0Config.tiny()
        jparams = jax.jit(jpi0.init, static_argnums=1)(jax.random.key(0), jcfg)
        tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        rng = np.random.default_rng(5)
        std_batches = [make_batch(jcfg, GLOBAL_ROWS, rng) for _ in range(2)]
        draws = jax_draws(jcfg, 2, std_batches[0]["actions"].shape)
        fused_batch = make_batch(jcfg, GLOBAL_ROWS, rng)
        ckpt_batch = make_batch(jcfg, GLOBAL_ROWS, rng)

        # a one-rank run of the joint recipe, its update-1 checkpoint for the ranks to resume
        from intact_tpu_torch.train.trainer import Trainer

        one = Trainer(child.recipe_config(child.JOINT_RECIPE, **{
            **CKPT_OVERRIDES, "mesh.fsdp": 1, "per_device_batch_size": GLOBAL_ROWS, "n_updates": 1,
            "log_dir": workdir / "one"}), device="cpu")
        one.train()
        inputs = {
            "params": tcm.flatten_paths(tparams), "std_opt": STD_OPT, "std_batches": [tensors(b) for b in std_batches],
            "std_noise": [torch.from_numpy(n) for n, _ in draws], "std_time": [torch.from_numpy(t) for _, t in draws],
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
            refs = references(jcfg, tcfg, jparams, tparams, std_batches, draws, one, inputs)
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


def references(jcfg, tcfg, jparams, tparams, std_batches, draws, one, inputs) -> dict:
    """What the ranks are held to: the port's one-rank standard step and
    JAX's jit_train_step on 2-device meshes over the same two micro-batches,
    the one-rank continuation of the checkpointed run, and one rank's frames."""
    out = {}
    ttx, _ = t_make_optimizer(TOpt(**STD_OPT))
    tstate = t_init_state(tcm.tree_map(lambda x: x.clone(), tparams), ttx, seed=0)
    tstep = t_make_step(lambda p, rng, b, n, t: tpi0.compute_loss(p, rng, b, tcfg, T32, noise=n, time=t), ttx)
    losses = []
    for batch, (noise, time_) in zip(std_batches, draws):
        tstate, m = tstep(tstate, tensors(batch), noise=torch.from_numpy(noise), time=torch.from_numpy(time_))
        losses.append(m["l2_loss"].item())
    out["port"] = {"losses": losses, "params": tcm.flatten_paths(tstate.params)}

    jtx, _ = j_make_optimizer(JOpt(**STD_OPT))
    jstep = j_make_step(lambda p, k, b: jpi0.compute_loss(p, k, b, jcfg, J32), jtx, J32)
    for data, fsdp in ((2, 1), (1, 2)):
        mesh = j_make_mesh(JMeshConfig(data=data, fsdp=fsdp, tensor=1), devices=jax.devices()[:2])
        state = j_init_state(jax.tree.map(lambda x: jnp.array(np.asarray(x)), jparams), jtx, seed=0)  # donated
        sh = state_shardings(state, mesh)
        state = jax.device_put(state, sh)
        step = jit_train_step(jstep, mesh, sh, batch_sharding(mesh))
        losses = []
        for batch in std_batches:
            state, m = step(state, jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, batch_sharding(mesh)))
            losses.append(float(m["l2_loss"]))
        out[f"jax_{data}x{fsdp}"] = {"losses": losses, "params": {
            k: np.asarray(v) for k, v in tcm.flatten_paths(jax.tree.map(np.asarray, state.params)).items()}}

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


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_standard_step_matches_one_rank_and_jax(groups, mesh):
    """Two ranks, two micro-steps of 2 rows each (accumulation 2): the mean of
    the ranks' losses per micro-step and the params after the update against
    the one-rank port step on the 4-row micro-batches and JAX's 2-device step."""
    ranks = [res[f"std_{mesh}"] for res in groups["pair"]]
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    losses = np.mean([r["losses"] for r in ranks], axis=0)
    for ref in ("port", f"jax_{mesh}"):
        want = groups["refs"][ref]
        np.testing.assert_allclose(losses, want["losses"], rtol=1e-4, err_msg=ref)
        assert_params_close({k: v.numpy() for k, v in ranks[0]["params"].items()}, want["params"], 1e-4, ref)


def test_standard_step_with_no_leaf_to_split(groups):
    """At fsdp 2 with every leaf below the split threshold (fp32 moments,
    replicated), the second rank counts no leaf in the clip's sum: the update
    still matches one rank's on the whole micro-batches."""
    ranks = [res["std_unsplit"]["ranks"] for res in groups["pair"]]
    one = groups["pair"][0]["std_unsplit"]["one"]
    assert not one["local_q_rows"] and ranks[0]["collectives"]["reduce_scatter"] == 0
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    np.testing.assert_allclose(np.mean([r["losses"] for r in ranks], axis=0), one["losses"], rtol=1e-4)
    assert_params_close({k: v.numpy() for k, v in ranks[0]["params"].items()},
                        {k: v.numpy() for k, v in one["params"].items()}, 1e-4, "unsplit")


def test_standard_step_splits_the_moments_over_fsdp(groups):
    """At fsdp 2 each rank holds its share of every 8-bit leaf's block rows
    (some shares empty), the gathered moments are one layout for every mesh,
    and the update issues the collectives the code implies."""
    split = [res["std_1x2"] for res in groups["pair"]]
    whole = groups["pair"][0]["std_2x1"]
    assert whole["local_q_rows"] and set(split[0]["local_q_rows"]) == set(whole["local_q_rows"])
    for k, nb in whole["local_q_rows"].items():
        assert split[0]["local_q_rows"][k] == split[1]["local_q_rows"][k] == -(-nb // 2), k
    assert any(nb == 1 for nb in whole["local_q_rows"].values())  # one block: the second rank's share is empty
    for k, m in whole["mu"].items():
        assert m.shape == split[0]["mu"][k].shape, k
    n_split = len(whole["local_q_rows"])
    n_leaves = len(whole["params"])
    for res in split:  # per update: a reduce-scatter, an all-reduce (data) and an all-gather per split leaf, one
        # all-reduce per replicated leaf, one for the clip's sum of squares
        assert res["collectives"] == {"all_reduce": n_split + (n_leaves - n_split) + 1, "reduce_scatter": n_split,
                                      "all_gather": n_split, "broadcast": 0}


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


def test_checkpoint_resumes_across_world_sizes(groups, monkeypatch):
    """A one-rank save resumes on two fsdp ranks (their gathered state equal to
    the file); their next update, saved from the ranks, resumes on one rank
    and equals continuing on one rank."""
    from intact_tpu_torch.train.trainer import Trainer

    ranks = [res["ckpt"] for res in groups["pair"]]
    assert all(r["restored_equal"] for r in ranks)
    assert_equal_trees(ranks[0]["params"], ranks[1]["params"], "ranks' params")
    saved = Path(ranks[0]["saved"])
    assert saved.name == "step_2" and (saved / ckpt.AUX_FILE).exists()
    tiny_pipeline(monkeypatch)
    resumed = Trainer(child.recipe_config(child.JOINT_RECIPE, **CKPT_OVERRIDES, **{
        "mesh.fsdp": 1, "per_device_batch_size": GLOBAL_ROWS, "log_dir": groups["workdir"] / "three",
        "load_from_checkpoint": saved}), device="cpu")
    assert resumed.cnt_update == 2
    assert_equal_trees(tcm.flatten_paths(resumed.state.params), ranks[0]["params"], "resumed")
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

def test_repo_recipe_at_its_mesh_on_four_ranks(groups, monkeypatch):
    """pi0_finetune_bridge.yaml's mesh (data -1, fsdp 4) resolves to 1 x 4 x 1
    at world 4: one update of 2 rows per rank (global 8), the ranks' params
    bit-equal after it, each holding a quarter of the 8-bit leaves' rows,
    the validation metrics averaged over the ranks, the last update saved
    from the ranks and restored on one rank."""
    from intact_tpu_torch.train.trainer import Trainer

    quad = groups["quad"]
    for res in quad:
        assert res["mesh"] == {"data": 1, "fsdp": 4, "tensor": 1} and res["accum"] == 1
        assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
        assert_equal_trees(res["params"], quad[0]["params"], "ranks' params")
        assert res["validations"] == quad[0]["validations"] and len(res["validations"]) == 1
        assert np.isfinite(res["validations"][0]["l1_loss"])
        steps = {k: v for k, v in res["collectives"].items() if k != "broadcast"}  # the serving group's collective
        assert min(steps.values()) > 0 and res["collectives"]["broadcast"] == 0
    nb = {k: rows for k, rows in groups["pair"][0]["std_2x1"]["local_q_rows"].items()}
    for k, rows in quad[0]["local_q_rows"].items():
        assert rows == -(-nb[k] // 4), k
    step = Path(quad[0]["ckpt_root"]) / "step_1"
    assert (step / ckpt.AUX_FILE).exists()
    tiny_pipeline(monkeypatch)
    resumed = Trainer(child.recipe_config(child.JOINT_RECIPE, **{
        "mesh.fsdp": 1, "per_device_batch_size": 2, "global_batch_size": 2, "log_dir": groups["workdir"] / "four",
        "load_from_checkpoint": step}), device="cpu")
    assert_equal_trees(tcm.flatten_paths(resumed.state.params), quad[0]["params"], "resumed on one rank")


def test_one_rank_trainer_has_no_group(groups):
    one = groups["one"]
    assert one.mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1} and one.main_rank and not one.mesh.distributed

