"""The tensor axis for the token-decoding families (Pi0FAST, native SpatialVLA,
native Magma): spawned gloo groups on the CPU
(tests/test_torch_tensor_parallel_ar_ranks.py).

Two groups start together, each rank a process of torch.multiprocessing's
spawn that imports no JAX, each joined within JOIN_TIMEOUT or the test fails
(its processes are killed):

  * two ranks, mesh (1, 1, 2): every case, and the server role's int8 Magma
    wrapper switched to a checkpoint saved in the one-rank layout;
  * four ranks: every case at (1, 1, 4) (Gemma2's and LLaMA's two tiny K/V
    heads do not split: each rank keeps the one its query head reads), the
    divisible cases at (1, 2, 2) (the tensor slices split further over fsdp,
    two batch coordinates of two rows each).

A case is a family's tiny config at a vocabulary that 2 and 4 divide (the
vocabulary-parallel table and head) or at 99 rows, which no t divides (the
table whole on every rank), on parameters made by the JAX `init` and carried
across, with four rows of ragged prompts. Held, in fp32 compute: every rank's
tokens equal to `jax.jit` of the JAX package's single-device
`sample_actions` / `predict_action_tokens` / `generate` on its rows, and every
step's logits, joined over the tensor ranks, within 1e-4 (relative and
absolute: tests/test_torch_magma.py's tolerance for logits) of the ones the
compiled JAX decode computes (read through `jax.debug.callback`); in int8,
tokens and logits bit-equal to the port on one rank (one thread, as the
ranks run: a float product's summation order follows the thread count).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_distributed as dist_test
import test_torch_tensor_parallel_ar_ranks as child
from intact_tpu.models import common as jcm
from intact_tpu.models import gemma2 as jgemma2
from intact_tpu.models import llama as jllama
from intact_tpu.models.magma import model as jmagma
from intact_tpu.models.magma.config import MagmaConfig as JMagmaCfg
from intact_tpu.models.pi0fast import model as jfast
from intact_tpu.models.pi0fast.config import Pi0FASTConfig as JFastCfg
from intact_tpu.models.spatialvla import model as jsvla
from intact_tpu.models.spatialvla.config import SpatialVLAConfig as JSvlaCfg
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models.tokenizer import HashTokenizer
from intact_tpu_torch.parallel import tensor as tensor_parallel

JOIN_TIMEOUT = dist_test.JOIN_TIMEOUT
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
ROWS = 4
# divisible vocabularies (2 and 4 divide them) and the ragged one
VOCAB = {("pi0fast", "div"): 256, ("spatialvla", "div"): 296, ("magma", "div"): 512}
RAGGED = 99
CASES = [(f, k) for f in child.FAMILIES for k in ("div", "ragged")]
TASKS = ["put carrot on plate", "stack the green block on the yellow block", "open the drawer", "pick up the can"]


def jax_config(family: str, vocab: int):
    if family == "pi0fast":
        cfg = JFastCfg.tiny()
        return dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, vocab_size=vocab))
    if family == "spatialvla":
        cfg = JSvlaCfg.tiny()
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, vocab_size=vocab))
    cfg = JMagmaCfg.tiny()
    image_id = cfg.image_token_id if cfg.image_token_id < vocab else vocab - 1
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, vocab_size=vocab), image_token_id=image_id)


JAX = {"pi0fast": (jfast, jfast, "_logits"), "spatialvla": (jsvla, jgemma2, "logits"),
       "magma": (jmagma, jllama, "logits")}


def case_inputs(family: str, cfg, rng: np.random.Generator) -> dict:
    """Four rows of the family's model inputs, prompts of different lengths."""
    if family == "magma":
        tokens, masks = child.module("magma").build_prompt(
            HashTokenizer(vocab_size=cfg.image_token_id, max_length=cfg.max_prompt_tokens), TASKS, cfg)
        s = cfg.image_size
        return {"images": rng.normal(size=(ROWS, s, s, 3)).astype(np.float32), "tokens": tokens, "masks": masks}
    lang = 8
    lang_masks = np.arange(lang)[None] < np.array([8, 5, 3, 6])[:, None]
    if family == "pi0fast":
        s = cfg.vision.image_size
        return {"images": rng.uniform(-1, 1, (ROWS, 1, s, s, 3)).astype(np.float32),
                "img_masks": np.ones((ROWS, 1), bool),
                "lang_tokens": rng.integers(0, RAGGED, (ROWS, lang)).astype(np.int32), "lang_masks": lang_masks,
                "state": rng.standard_normal((ROWS, cfg.max_state_dim), dtype=np.float32)}
    s, g = cfg.vision.image_size, cfg.vision.grid
    return {"images": rng.uniform(-1, 1, (ROWS, s, s, 3)).astype(np.float32),
            "depth": rng.uniform(0.5, 2.0, (ROWS, g, g)).astype(np.float32),
            "lang_tokens": rng.integers(0, cfg.spatial_offset, (ROWS, lang)).astype(np.int32),
            "lang_masks": lang_masks}


def jax_reference(family: str, jcfg, jparams, inputs: dict, monkeypatch) -> dict:
    """jax.jit of the family's single-device entry -> its tokens and each
    step's logits, read out of the compiled decode by a debug callback."""
    top, holder, name = JAX[family]
    real, steps = getattr(holder, name), []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        jax.debug.callback(lambda x: steps.append(np.asarray(x)), out, ordered=True)
        return out

    with monkeypatch.context() as m:
        m.setattr(holder, name, recorded)
        if family == "pi0fast":
            fn = jax.jit(lambda p, *a: top.sample_actions(p, jax.random.key(0), *a, jcfg, J32, return_tokens=True))
            out = fn(jparams, *(inputs[k] for k in ("images", "img_masks", "lang_tokens", "lang_masks", "state")))
        elif family == "spatialvla":
            fn = jax.jit(lambda p, *a: top.predict_action_tokens(p, *a, jcfg, J32))
            out = fn(jparams, *(inputs[k] for k in ("images", "depth", "lang_tokens", "lang_masks")))
        else:
            fn = jax.jit(lambda p, *a: top.generate(p, *a, jcfg, J32))
            out = fn(jparams, *(inputs[k] for k in ("images", "tokens", "masks")))
        tokens = np.asarray(out).astype(np.int64)
    logits = steps[:tokens.shape[1]]  # the JAX decode also feeds its last token through the trunk
    if family == "pi0fast":
        win = jcfg.action_vocab_size or jcfg.n_action_bins
        logits = [x[:, jcfg.vlm.vocab_size - win:] for x in logits]
    return {"tokens": tokens, "logits": logits}


def one_rank(spec: dict) -> dict:
    """The port without a group in fp32 and int8, on one thread as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {p: child.decode(spec, None, quantize=p == "int8") for p in ("fp32", "int8")}
    finally:
        torch.set_num_threads(threads)


def wrapper_inputs(tmp_path, rng: np.random.Generator) -> dict:
    """The int8 magma_native_tiny server config (fp32 params), a checkpoint of
    random weights in the one-rank layout and four rows to decode."""
    from tests.test_torch_magma import pipeline_configs
    from intact_tpu_torch.models.magma import model as tmagma
    from intact_tpu_torch.train import checkpoint as ckpt

    _, cfg = pipeline_configs()
    cfg.eval_cfg.quantize_int8 = True
    mc = cfg.make_model_config()
    step = ckpt.save_checkpoint(tmp_path / "ckpt", tmagma.init(mc, seed=7, device="cpu"), step=1)
    s = mc.image_size
    return {"config": cfg, "checkpoint": str(step), "tasks": TASKS,
            "images": rng.integers(0, 256, (ROWS, s, s, 3), dtype=np.uint8)}


def one_rank_wrapper(spec: dict) -> np.ndarray:
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = make_policy_wrapper(spec["config"], device="cpu")
        w.policy = dataclasses.replace(w.policy, compute_dtype=torch.float32)
        w.switch_model(spec["checkpoint"])
        return w.generate_tokens(spec["images"], spec["tasks"])
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Write the cases, spawn the two groups, compute the JAX and one-rank
    references meanwhile, join, and hand everything to the tests."""
    workdir = tmp_path_factory.mktemp("tensor_ar_ranks")
    mp_ = pytest.MonkeyPatch()
    try:
        rng = np.random.default_rng(18)
        specs, later = {}, {}
        for family, kind in CASES:
            vocab = VOCAB.get((family, kind), RAGGED)
            jcfg, tcfg = jax_config(family, vocab), child.config(family, vocab)
            jparams = jax.tree.map(np.asarray, jax.jit(JAX[family][0].init, static_argnums=1)(jax.random.key(3),
                                                                                                  jcfg))
            inputs = case_inputs(family, tcfg, rng)
            params = convert.from_jax_params(jparams, tcfg, device="cpu")
            specs[(family, kind)] = {"case": (family, vocab), "params": tcm.flatten_paths(params),
                                     "inputs": {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}}
            later[(family, kind)] = (jcfg, jparams, inputs)
        wrapper = wrapper_inputs(workdir, rng)
        torch.save({"cases": specs, "wrapper": wrapper}, workdir / "inputs.pt")
        deadline = time.monotonic() + JOIN_TIMEOUT
        contexts = {"pair": dist_test.spawn(child.pair, 2, workdir), "quad": dist_test.spawn(child.quad, 4, workdir)}
        try:
            refs = {key: {"jax": jax_reference(key[0], *args, mp_), "port": one_rank(specs[key])}
                    for key, args in later.items()}
            refs["wrapper"] = one_rank_wrapper(wrapper)
        except BaseException:
            for ctx in contexts.values():
                for p in ctx.processes:
                    p.kill()
            raise
        for name, ctx in contexts.items():
            dist_test.join(ctx, deadline, name)
        return {"refs": refs, "specs": specs,
                **{name: [torch.load(workdir / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]
                   for name, world in (("pair", 2), ("quad", 4))}}
    finally:
        mp_.undo()


def joined(ranks: list, coordinate: int, precision: str, step: int, width: int) -> torch.Tensor:
    """A step's logits of one batch coordinate: its tensor ranks' columns
    joined in tensor order, or the whole logits each of them holds."""
    parts = [r[precision]["logits"][step] for r in sorted(ranks, key=lambda r: r["tensor_index"])
             if r["batch_index"] == coordinate]
    if sum(p.shape[-1] for p in parts) == width:
        return torch.cat(parts, dim=-1)
    assert all(p.shape[-1] == width and torch.equal(p, parts[0]) for p in parts)
    return parts[0]


MESHES = [("pair", "cases", (1, 1, 2)), ("quad", "1x1x4", (1, 1, 4)), ("quad", "1x2x2", (1, 2, 2))]
GRID = [(g, k, m, c) for g, k, m in MESHES for c in CASES if m != (1, 2, 2) or c[1] == "div"]
IDS = [f"{'x'.join(map(str, m))}-{c[0]}-{c[1]}" for _, _, m, c in GRID]


def case_ranks(groups, group: str, key: str, case) -> list:
    return [res[key][case] for res in groups[group]]


@pytest.mark.parametrize("group,key,mesh,case", GRID, ids=IDS)
def test_fp32_decode_matches_jax_single_device(groups, group, key, mesh, case):
    """Every rank's tokens equal the JAX package's compiled single-device
    decode on its rows; every step's logits, joined over the coordinate's
    tensor ranks, within 1e-4 of the JAX decode's."""
    ranks = case_ranks(groups, group, key, case)
    ref = groups["refs"][case]["jax"]
    coords = mesh[0] * mesh[1]
    per = ROWS // coords
    for r in ranks:
        rows = slice(r["batch_index"] * per, (r["batch_index"] + 1) * per)
        np.testing.assert_array_equal(r["fp32"]["tokens"].numpy(), ref["tokens"][rows])
    for c in range(coords):
        rows = slice(c * per, (c + 1) * per)
        assert len(ranks[0]["fp32"]["logits"]) == len(ref["logits"])
        for s, want in enumerate(ref["logits"]):
            got = joined(ranks, c, "fp32", s, want.shape[-1])
            np.testing.assert_allclose(got.numpy(), want[rows], **LOGITS_TOL, err_msg=f"step {s}")


@pytest.mark.parametrize("group,key,mesh,case", GRID, ids=IDS)
def test_int8_decode_is_one_ranks_bit_for_bit(groups, group, key, mesh, case):
    """int8: every rank's tokens and every step's joined logits bit-equal to
    the port's on one rank (the column-parallel W8A8 products and the
    vocabulary-parallel table exact per column, the row-parallel ones summed
    as int32 partials against the whole row's absmax)."""
    ranks = case_ranks(groups, group, key, case)
    ref = groups["refs"][case]["port"]["int8"]
    per = ROWS // (mesh[0] * mesh[1])
    for r in ranks:
        rows = slice(r["batch_index"] * per, (r["batch_index"] + 1) * per)
        assert torch.equal(r["int8"]["tokens"], ref["tokens"][rows])
        for s, want in enumerate(ref["logits"]):
            assert torch.equal(joined(ranks, r["batch_index"], "int8", s, want.shape[-1]), want[rows]), s
    counts = ranks[0]["int8"]["collectives"]
    assert counts["tensor_all_reduce"] > 0 and counts["tensor_all_reduce_max"] > 0 and counts["tensor_all_gather"] == 0


# the leaves a case holds as tensor slices at t = 2: the table (a divisible vocabulary), Magma's lm_head, and
# every tower's q, o and MLP; the K/V kernels where their heads split
SPLIT = {
    "pi0fast": {"vlm_embed/embedding", "vlm/blocks/attn/q/kernel", "vlm/blocks/mlp/down/kernel",
                "siglip/blocks/attn/k/kernel"},
    "spatialvla": {"lm/embed/embedding", "lm/blocks/attn/k/kernel", "lm/blocks/attn/o/kernel",
                   "siglip/blocks/mlp/fc1/kernel"},
    "magma": {"lm/embed/embedding", "lm/lm_head/kernel", "lm/blocks/attn/v/kernel", "lm/blocks/mlp/up/kernel"},
}


@pytest.mark.parametrize("case", CASES, ids=[f"{f}-{k}" for f, k in CASES])
def test_tensor_slices_follow_the_rules(groups, case):
    """At t = 2 the table splits where its vocabulary divides and stays whole
    at 99 rows, Magma's lm_head splits its columns, the K/V kernels split
    where their heads do (not Pi0FAST's one head); ConvNeXt, the projectors,
    Ego3D and action_start stay whole. At t = 4 Gemma2's and LLaMA's two K/V
    heads stay whole."""
    family, kind = case
    fp32 = groups["pair"][0]["cases"][case]["fp32"]["split"]
    want = set(SPLIT[family])
    if kind == "ragged":
        want -= {"vlm_embed/embedding", "lm/embed/embedding", "lm/lm_head/kernel"}
    assert want <= set(fp32)
    assert not {p for p in fp32 if p.split("/")[0] in ("vision", "projector", "ego3d", "img_proj", "action_start")}
    assert ("vlm/blocks/attn/k/kernel" in fp32) is False
    assert (("lm/embed/embedding" in fp32) or ("vlm_embed/embedding" in fp32)) == (kind == "div")
    int8 = groups["pair"][0]["cases"][case]["int8"]["split"]
    if family != "pi0fast":  # the int8 table: codes and scales split together
        assert ({"lm/embed/embedding_q", "lm/embed/embed_scale"} <= set(int8)) == (kind == "div")
    quad = groups["quad"][0]["1x1x4"][case]["fp32"]["split"]
    assert "lm/blocks/attn/k/kernel" not in quad and "siglip/patch_embed/kernel" not in quad


def test_checkpoint_switch_at_1x1x2_is_one_ranks(groups):
    """The server role's int8 Magma wrapper over (1, 1, 2): switch_model to a
    checkpoint saved in the one-rank layout restores each rank's tensor
    slices, and the fused rows' tokens equal the one-rank wrapper's on the
    same checkpoint."""
    lead, other = (res["wrapper"] for res in groups["pair"])
    np.testing.assert_array_equal(lead["ids"], groups["refs"]["wrapper"])
    assert lead["generation"] == other["generation"] == 1
    assert {"lm/embed/embedding_q", "lm/lm_head/kernel_q", "lm/blocks/mlp/down/kernel_q"} <= set(other["split"])


# ---------------------------------------------------------------------------
# without a group
# ---------------------------------------------------------------------------

def ranks_of(fn, parts: int):
    """fn(tp) on each of `parts` tensor ranks in turn with the tensor
    collectives replaced by their results over the ranks: a first pass
    records what each rank sends, a second gives every rank the reduction."""
    from intact_tpu_torch.parallel import collectives

    sent = {"sum": [], "max": []}
    real = collectives.tensor_all_reduce, collectives.tensor_all_reduce_max
    try:
        collectives.tensor_all_reduce = lambda x, g: sent["sum"].append(x.clone()) or x
        collectives.tensor_all_reduce_max = lambda x, g: sent["max"].append(x.clone()) or x
        for r in range(parts):
            fn(tensor_parallel.TensorParallel(None, parts, r))
        total = {k: (torch.stack(v).sum(0) if k == "sum" else torch.stack(v).amax(0)) if v else None
                 for k, v in sent.items()}
        collectives.tensor_all_reduce = lambda x, g: x.copy_(total["sum"])
        collectives.tensor_all_reduce_max = lambda x, g: x.copy_(total["max"])
        return [fn(tensor_parallel.TensorParallel(None, parts, r)) for r in range(parts)]
    finally:
        collectives.tensor_all_reduce, collectives.tensor_all_reduce_max = real


@pytest.mark.parametrize("parts", [2, 4])
def test_vocab_argmax_is_the_first_maximum(parts):
    """vocab_argmax over column slices equals torch.argmax over the whole:
    ties within a slice and across a slice boundary go to the lower index,
    -0.0 ties +0.0, a row of -inf gives 0; a window whose part on some ranks
    is empty (vocab_window) and a table left whole on every rank."""
    gen = torch.Generator().manual_seed(parts)
    v = 64
    logits = torch.randn(6, v, generator=gen).round()  # many ties
    n = v // parts
    logits[1, n - 1] = logits[1, n] = 50.0  # a tie across the first boundary
    logits[2] = 0.0
    logits[2, 3 * n // 2:] = -0.0
    logits[3] = float("-inf")
    logits[4, -1] = 60.0
    logits[5, 7] = logits[5, v - 1] = 70.0
    want = logits.argmax(dim=-1)
    got = ranks_of(lambda tp: tensor_parallel.vocab_argmax(logits[:, tp.columns(n)], tp), parts)
    assert all(torch.equal(g, want) for g in got)
    for first in (v - 5, v - n - 3, 0):  # the action window: the last rank's rows, two ranks', all
        def windowed(tp):
            lo, offset = tensor_parallel.vocab_window(tp, n, first)
            return tensor_parallel.vocab_argmax(logits[:, tp.columns(n)][:, lo:], tp, offset)

        got = ranks_of(windowed, parts)
        assert all(torch.equal(g, logits[:, first:].argmax(dim=-1)) for g in got), first
    assert torch.equal(tensor_parallel.vocab_argmax(logits, None), want)


@pytest.mark.parametrize("parts", [2, 4])
def test_int8_vocab_lookup_is_the_whole_tables(parts):
    """The vocabulary-parallel int8 lookup (each rank's codes times its
    scales, zeros elsewhere, summed over tensor) equals the whole table's
    lookup bit for bit, out-of-range ids clipped as there."""
    gen = torch.Generator().manual_seed(parts)
    q = tcm.quantize_embed({"embedding": torch.randn(48, 16, generator=gen)})
    ids = torch.tensor([[0, 11, 12, 47], [23, 24, -3, 90]])
    want = tcm.embed_lookup(q, ids, tcm.FP32_POLICY)
    n = 48 // parts
    got = ranks_of(lambda tp: tensor_parallel.vocab_lookup(q["embedding_q"][tp.columns(n)], ids, 48, tp,
                                                           q["embed_scale"][tp.columns(n)]), parts)
    assert all(torch.equal(g, want) for g in got)


def test_rules_keep_the_tensor_axis_at_head_granularity_for_gemma2_and_llama():
    """SpatialVLA-4B's Gemma2 (8 query heads over 4 K/V heads) splits its
    K/V over tensor at 2 and 4 and keeps them whole at 8; Magma-8B's LLaMA-3
    (32 over 8) splits them at 2, 4 and 8; Pi0FAST's Gemma-2B keeps its one
    K/V head whole. The tables split by rows where the vocabulary divides
    (SpatialVLA's 259,714 by 2 only), the lm_head's K-major codes by rows
    (its columns), ConvNeXt and the projector nowhere."""
    from intact_tpu_torch.models.magma import model as tmagma
    from intact_tpu_torch.models.magma.config import MagmaConfig
    from intact_tpu_torch.models.pi0fast import model as tfast
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig
    from intact_tpu_torch.models.spatialvla import model as tsvla
    from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig
    from intact_tpu_torch.parallel import sharding
    from intact_tpu_torch.parallel.mesh import Mesh

    def spec(path, shape, t, heads):
        mesh = Mesh(1, 1, t, 0, dict.fromkeys(("data", "fsdp", "tensor", "batch", "model", "world")))
        return sharding.spec_for_path(path, shape, mesh, heads=heads)

    svla, magma, fast = (SpatialVLAConfig.spatialvla_4b(), MagmaConfig.magma_8b(), Pi0FASTConfig.bridge())
    hs, hm, hf = tsvla.tensor_heads(svla), tmagma.tensor_heads(magma), tfast.tensor_heads(fast)
    for t in (2, 4, 8):
        k = spec("lm/blocks/attn/k/kernel", (26, 2304, 1024), t, hs)
        assert k == ((None, "fsdp", "tensor") if t < 8 else (None, "fsdp", None)), t
        assert spec("lm/blocks/attn/q/kernel_q", (26, 2048, 2304), t, hs) == (None, "tensor", "fsdp")
        assert spec("lm/blocks/attn/v/kernel_q", (32, 1024, 4096), t, hm) == (None, "tensor", "fsdp")
        assert spec("vlm/blocks/attn/k/kernel", (18, 2048, 256), t, hf) == (None, "fsdp", None)
        assert spec("lm/embed/embedding_q", (svla.lm.vocab_size, 2304), t, hs)[0] == ("tensor" if t == 2 else None)
        assert spec("lm/embed/embed_scale", (svla.lm.vocab_size,), t, hs) == (("tensor",) if t == 2 else (None,))
        assert spec("lm/lm_head/kernel_q", (128_256, 4096), t, hm) == ("tensor", "fsdp")
        assert spec("lm/lm_head/kernel", (4096, 128_256), t, hm) == ("fsdp", "tensor")
        assert spec("vision/stage_2/pw1/kernel", (30, 1536, 6144), t, hm) == (None, None, None)
        assert spec("projector/linear_1/kernel", (3072, 4096), t, hm) == (None, None)
        assert spec("ego3d/linear_1/kernel", (48, 256), t, hs) == (None, None)
        assert spec("action_start", (1, 1, 2048), t, hf) == (None, None, None)


def test_sessions_preprocess_without_cv2_at_the_models_size(monkeypatch):
    """SpatialVLA's and Magma's sessions import cv2 only where they resize:
    frames (and SpatialVLA's depth) already at the model's size pass with
    cv2 unimportable, as on the card."""
    import sys
    import types

    from intact_tpu_torch.models.magma.config import MagmaConfig
    from intact_tpu_torch.models.spatialvla import model as tsvla
    from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig
    from intact_tpu_torch.serve.policy_wrapper import MagmaSession, SpatialVLASession

    monkeypatch.setitem(sys.modules, "cv2", None)

    class Adapter:
        def __init__(self, size):
            self.size = size

        def preprocess(self, obs):
            return {"image": np.zeros((1, self.size, self.size, 3), np.float32), "task": [obs["task"]]}

        def reset(self):
            pass

    svla = SpatialVLAConfig.tiny()
    g = svla.vision.grid
    session = SpatialVLASession(types.SimpleNamespace(model_cfg=svla, model=tsvla), Adapter(svla.vision.image_size))
    for depth in (None, np.ones((g, g), np.float32)):
        out = session.preprocess({"task": "t", **({} if depth is None else {"observation.depth": depth})})
        assert out["image"].dtype == np.uint8 and out["depth"].shape == (1, g, g)
    magma = MagmaConfig.tiny()
    out = MagmaSession(types.SimpleNamespace(model_cfg=magma), Adapter(magma.image_size)).preprocess({"task": "t"})
    assert out["image"].shape == (1, magma.image_size, magma.image_size, 3)
    with pytest.raises(ImportError):
        MagmaSession(types.SimpleNamespace(model_cfg=magma), Adapter(magma.image_size + 2)).preprocess({"task": "t"})
