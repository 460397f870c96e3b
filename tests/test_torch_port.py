"""Rules of the PyTorch port: it stands alone (no jax, nothing of intact_tpu),
its configs equal the reference's, its entry points run on CUDA unless told
otherwise, and its tokenizer is the reference's."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# the rank children the multi-rank tests spawn run only the port, as the card does
RANK_CHILDREN = [REPO / "tests" / f"test_torch_{name}.py" for name in (
    "distributed_ranks", "serve_ranks_child", "tensor_parallel_ranks", "tensor_parallel_ar_ranks")]
PORT_FILES = sorted(p for p in (REPO / "intact_tpu_torch").rglob("*.py") if "_build" not in p.parts) + [
    REPO / "chip_smoke.py"] + RANK_CHILDREN


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_intact_tpu(path):
    bad = {m for m in imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "intact_tpu")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


# The card machine has none of these. The training-data path (data/, native/,
# ops/build.py, train/) reads and decodes RLDS without them.
HOST_BANNED = ("tensorflow", "tensorflow_datasets", "google.protobuf", "PIL", "cv2")
# Serving- and client-side resizes that predate the RLDS path, each imported
# inside the function that resizes a frame whose size differs from the
# model's (as the JAX package's adapters resize): cv2 bilinear / area and
# PIL's resize_with_pad, held bit-equal to the JAX package's by the adapter
# tests. Frames already at the model's size, as on the card, import none of
# them.
RESIZE_ONLY = {
    "intact_tpu_torch/protocol/image_tools.py": {"PIL"},
    "intact_tpu_torch/serve/policy_wrapper.py": {"cv2"},
}


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in HOST_BANNED)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_tensorflow_protobuf_pil_or_cv2(path):
    """At any level of any module: none of HOST_BANNED, but for the listed
    function-level resizes; at module level, none at all."""
    rel = str(path.relative_to(REPO))
    tree = ast.parse(path.read_text(), str(path))
    top = {a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names}
    top |= {node.module for node in tree.body if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert not {m for m in top if _banned(m)}, f"{rel} imports {sorted(m for m in top if _banned(m))} at module level"
    bad = {m for m in imported_modules(path) if _banned(m)} - RESIZE_ONLY.get(rel, set())
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_resize_only_imports_are_where_listed():
    for rel, mods in RESIZE_ONLY.items():
        assert {m for m in imported_modules(REPO / rel) if _banned(m)} == mods, rel


def test_port_files_found():
    assert len(PORT_FILES) > 15


def test_port_walk_covers_parallel():
    """The import walks above cover the parallel package (the mesh, the
    process group, the block-row split, the collectives, the tensor axis's
    regions)."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {f"intact_tpu_torch/parallel/{m}.py" for m in ("__init__", "mesh", "distributed", "sharding",
                                                           "collectives", "tensor")} <= names


def _fields(cls_or_obj):
    return {f.name: f.default for f in dataclasses.fields(cls_or_obj)}


def test_config_fields_and_defaults_match():
    from intact_tpu.models.gemma import GemmaConfig as JG
    from intact_tpu.models.pi0.config import Pi0Config as JP
    from intact_tpu.models.siglip import SigLIPConfig as JS
    from intact_tpu_torch.models.gemma import GemmaConfig as TG
    from intact_tpu_torch.models.pi0.config import Pi0Config as TP
    from intact_tpu_torch.models.siglip import SigLIPConfig as TS

    for j, t in ((JG, TG), (JS, TS), (JP, TP)):
        assert _fields(t) == _fields(j), t.__name__
    for make in ("bridge", "tiny"):
        jc, tc = getattr(JP, make)(), getattr(TP, make)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), make
        assert (tc.prefix_len, tc.suffix_len, tc.proj_width) == (jc.prefix_len, jc.suffix_len, jc.proj_width)

    from intact_tpu.models.pi0fast.config import Pi0FASTConfig as JF
    from intact_tpu_torch.models.pi0fast.config import Pi0FASTConfig as TF

    assert _fields(TF) == _fields(JF)
    for make in ("bridge", "tiny"):
        jc, tc = getattr(JF, make)(), getattr(TF, make)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), make
        assert tc.n_action_tokens == jc.n_action_tokens, make

    from intact_tpu.models.connector import ConnectorConfig as JC
    from intact_tpu.models.connector import tiny_test_config as jc_tiny
    from intact_tpu.models.dit import DiTConfig as JD
    from intact_tpu.models.dit import tiny_test_config as jd_tiny
    from intact_tpu.models.mvla.config import MVLAConfig as JM
    from intact_tpu.models.mvla.model import _dit_config as j_dit_config
    from intact_tpu_torch.models.connector import ConnectorConfig as TC
    from intact_tpu_torch.models.connector import tiny_test_config as tc_tiny
    from intact_tpu_torch.models.dit import DiTConfig as TD
    from intact_tpu_torch.models.dit import tiny_test_config as td_tiny
    from intact_tpu_torch.models.mvla.config import MVLAConfig as TM
    from intact_tpu_torch.models.mvla.model import dit_config as t_dit_config

    for j, t in ((JC, TC), (JD, TD), (JM, TM)):
        assert _fields(t) == _fields(j), t.__name__
    for jc, tc in ((JM(), TM()), (JM.tiny(), TM.tiny()), (jc_tiny(), tc_tiny()), (jd_tiny(), td_tiny()),
                   (j_dit_config(JM()), t_dit_config(TM()))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), type(tc).__name__
    assert TM().proj_width == JM().proj_width == 1024 and TM.tiny().proj_width == JM.tiny().proj_width

    from intact_tpu.models import gemma2 as jg2
    from intact_tpu.models.spatialvla.config import SpatialVLAConfig as JV
    from intact_tpu_torch.models import gemma2 as tg2
    from intact_tpu_torch.models.spatialvla.config import SpatialVLAConfig as TV

    for j, t in ((jg2.Gemma2Config, tg2.Gemma2Config), (JV, TV)):
        assert _fields(t) == _fields(j), t.__name__
    for jc, tc in ((jg2.gemma2_2b(), tg2.gemma2_2b()), (jg2.tiny_test_config(), tg2.tiny_test_config()),
                   (JV.spatialvla_4b(), TV.spatialvla_4b()), (JV.tiny(), TV.tiny())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), type(tc).__name__
    for jc, tc in ((JV.spatialvla_4b(), TV.spatialvla_4b()), (JV.tiny(), TV.tiny())):
        assert (tc.n_spatial_tokens, tc.spatial_offset, tc.tokens_per_action) == (
            jc.n_spatial_tokens, jc.spatial_offset, jc.tokens_per_action)

    from intact_tpu.models import convnext as jcn
    from intact_tpu.models import llama as jll
    from intact_tpu.models.magma.config import MagmaConfig as JMG
    from intact_tpu_torch.models import convnext as tcn
    from intact_tpu_torch.models import llama as tll
    from intact_tpu_torch.models.magma.config import MagmaConfig as TMG

    for j, t in ((jcn.ConvNeXtConfig, tcn.ConvNeXtConfig), (jll.LlamaConfig, tll.LlamaConfig), (JMG, TMG)):
        assert _fields(t) == _fields(j), t.__name__
    for jc, tc in ((jcn.convnext_tiny(), tcn.convnext_tiny()), (jcn.convnext_xxlarge(), tcn.convnext_xxlarge()),
                   (jcn.tiny_test_config(), tcn.tiny_test_config()), (jll.llama3_8b(), tll.llama3_8b()),
                   (jll.tiny_test_config(), tll.tiny_test_config()), (JMG.magma_8b(), TMG.magma_8b()),
                   (JMG.tiny(), TMG.tiny())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), type(tc).__name__
    for jc, tc in ((JMG.magma_8b(), TMG.magma_8b()), (JMG.tiny(), TMG.tiny())):
        assert tc.n_image_tokens == jc.n_image_tokens

    from intact_tpu.models import dreamvla as jdv
    from intact_tpu.models import t5 as jt5
    from intact_tpu.models.octo import upstream as jup
    from intact_tpu.models.octo.config import OctoConfig as JO
    from intact_tpu_torch.models import dreamvla as tdv
    from intact_tpu_torch.models import t5 as tt5
    from intact_tpu_torch.models.octo import upstream as tup
    from intact_tpu_torch.models.octo.config import OctoConfig as TO

    for j, t in ((jt5.T5Config, tt5.T5Config), (JO, TO), (jup.OctoUpstreamConfig, tup.OctoUpstreamConfig),
                 (jdv.DreamVLAConfig, tdv.DreamVLAConfig)):
        assert _fields(t) == _fields(j), t.__name__
    for jc, tc in ((jt5.t5_base(), tt5.t5_base()), (jt5.tiny_test_config(), tt5.tiny_test_config()),
                   (JO.small(), TO.small()), (JO.base(), TO.base()), (JO.tiny(), TO.tiny()),
                   (jup.octo_small(), tup.octo_small()), (jup.octo_base(), tup.octo_base()),
                   (jup.tiny_test_config(), tup.tiny_test_config()), (jdv.DreamVLAConfig(), tdv.DreamVLAConfig()),
                   (jdv.DreamVLAConfig.tiny(), tdv.DreamVLAConfig.tiny())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), type(tc).__name__
    for jc, tc in ((JO.small(), TO.small()), (JO.tiny(), TO.tiny())):
        assert (tc.tokens_per_frame, tc.tokenizer_max_length, tc.max_state_dim, tc.max_action_dim, tc.chunk_size,
                tc.n_action_steps, tc.num_cameras) == (jc.tokens_per_frame, jc.tokenizer_max_length, jc.max_state_dim,
                                                       jc.max_action_dim, jc.chunk_size, jc.n_action_steps,
                                                       jc.num_cameras)
    assert tup.octo_base().n_patches == jup.octo_base().n_patches == 256

    # the mesh: its config, axis order (tensor fastest) and the parameter rules, tensor axis included
    from intact_tpu.parallel import mesh as jmesh
    from intact_tpu.parallel import sharding as jsharding
    from intact_tpu_torch.parallel import mesh as tmesh
    from intact_tpu_torch.parallel import sharding as tsharding

    assert _fields(tmesh.MeshConfig) == _fields(jmesh.MeshConfig) and tmesh.AXIS_NAMES == jmesh.AXIS_NAMES
    assert [(p, tuple(s)) for p, s in jsharding.DEFAULT_RULES] == [(p, tuple(s)) for p, s in tsharding.DEFAULT_RULES]


def test_pipeline_config_fields_and_defaults_match():
    """The port's TrainPipelineConfig has the reference's fields, with equal
    defaults where they are plain values (eval_thresholds among them), but
    for `reference_only`: fields that nothing in the reference reads."""
    from intact_tpu.config.pipeline import TrainPipelineConfig as J
    from intact_tpu_torch.config.pipeline import TrainPipelineConfig as T

    def defaults(cls):
        out = {}
        for f in dataclasses.fields(cls):
            value = f.default_factory() if f.default is dataclasses.MISSING else f.default
            out[f.name] = value if type(value).__module__ == "builtins" else type(value).__name__
        return out

    reference_only = {"eval_log_metrics"}
    want = {k: v for k, v in defaults(J).items() if k not in reference_only}
    assert reference_only <= set(defaults(J)) and not reference_only & set(defaults(T))
    assert defaults(T) == want
    assert defaults(T)["eval_thresholds"] == [0.05, 0.1, 0.2, 0.3, 0.5]


def test_data_config_fields_and_defaults_match():
    """The sections the RLDS backend reads (data.train / data.val / data)."""
    from intact_tpu.config import pipeline as jp
    from intact_tpu_torch.config import pipeline as tp

    for name in ("TrainDataConfig", "ValDataConfig", "DataConfig"):
        j, t = getattr(jp, name)(), getattr(tp, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    read = {"dataset_mix", "data_path", "load_proprio", "shuffle_buffer_size", "window_size", "action_horizon",
            "max_action_future", "subsample_length", "image_dropout_prob", "dataset_statistics_path", "split",
            "skip_unlabeled", "num_parallel_calls", "service_address"}
    assert read <= set(_fields(tp.TrainDataConfig))


@pytest.mark.parametrize("entry", ["policy", "init", "server", "pi0fast_policy", "pi0fast_init", "mvla_policy",
                                   "mvla_init", "spatialvla_init", "spatialvla_wrapper", "magma_init",
                                   "magma_wrapper", "octo_init", "octo_upstream_init", "octo_wrapper",
                                   "distributed_initialize"])
def test_entry_points_raise_without_cuda_unless_given_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from intact_tpu_torch.models.pi0 import model
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.models.pi0fast import Pi0FASTConfig
    from intact_tpu_torch.models.pi0fast import model as fast
    from intact_tpu_torch.models.mvla import MVLAConfig
    from intact_tpu_torch.models.mvla import model as mvla

    from intact_tpu_torch.config.pipeline import EnvConfig, EvalConfig, TrainPipelineConfig
    from intact_tpu_torch.parallel import distributed
    from intact_tpu_torch.models.spatialvla import SpatialVLAConfig
    from intact_tpu_torch.models.spatialvla import model as svla
    from intact_tpu_torch.models.magma import MagmaConfig
    from intact_tpu_torch.models.magma import model as magma
    from intact_tpu_torch.models.octo import OctoConfig
    from intact_tpu_torch.models.octo import model as octo
    from intact_tpu_torch.models.octo import upstream as octo_upstream
    from intact_tpu_torch.serve.policy_wrapper import (
        MagmaNativePolicyWrapper,
        SpatialVLANativePolicyWrapper,
        make_policy_wrapper,
    )

    cfg, fcfg, mcfg = Pi0Config.tiny(), Pi0FASTConfig.tiny(), MVLAConfig.tiny()

    def pipe(model_type):
        """A server-role config of `model_type`, as the run CLI builds it."""
        return TrainPipelineConfig(
            name=model_type, model_cfg={"type": model_type}, tokenizer_path="hash",
            eval_cfg=EvalConfig(simulator_name="simpler", env_adapter="BridgeSimplerAdapter", task_list=["t"],
                                n_eval_episode=1, n_video=0, recording=False, role="server"),
            env=EnvConfig(dataset_statistics_path=str(REPO / "config/dataset/bridge_statistics.json"),
                          image_size=(28, 28)))

    call = {
        "policy": lambda **kw: Pi0Policy(cfg, tokenizer_path="hash", **kw),
        "init": lambda **kw: model.init(cfg, **kw),
        # the server role's builder (intact_tpu_torch.run --eval_cfg.role server)
        "server": lambda **kw: make_policy_wrapper(pipe("pi0_tiny"), **kw),
        "pi0fast_policy": lambda **kw: Pi0Policy(fcfg, tokenizer_path="hash", model_module=fast, **kw),
        "pi0fast_init": lambda **kw: fast.init(fcfg, **kw),
        "mvla_policy": lambda **kw: Pi0Policy(mcfg, tokenizer_path="hash", model_module=mvla, **kw),
        "mvla_init": lambda **kw: mvla.init(mcfg, **kw),
        "spatialvla_init": lambda **kw: svla.init(SpatialVLAConfig.tiny(), **kw),
        "spatialvla_wrapper": lambda **kw: SpatialVLANativePolicyWrapper(pipe("spatialvla_native_tiny"), **kw),
        "magma_init": lambda **kw: magma.init(MagmaConfig.tiny(), **kw),
        "magma_wrapper": lambda **kw: MagmaNativePolicyWrapper(pipe("magma_native_tiny"), **kw),
        "octo_init": lambda **kw: octo.init(OctoConfig.tiny(), **kw),
        "octo_upstream_init": lambda **kw: octo_upstream.init(octo_upstream.tiny_test_config(), **kw),
        "octo_wrapper": lambda **kw: make_policy_wrapper(pipe("octo_tiny"), **kw),
        # the trainer's first call: the process group's device (a world of one here, no launcher)
        "distributed_initialize": lambda **kw: distributed.initialize(**kw),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")  # explicit CPU works


def test_tokenizer_matches_reference():
    from intact_tpu.models.tokenizer import HashTokenizer as JT
    from intact_tpu_torch.models.tokenizer import HashTokenizer as TT

    texts = ["put the spoon on the towel", "", "stack the green block on the yellow block " * 10]
    for out, ref in zip(TT(1000, 12)(texts), JT(1000, 12)(texts)):
        np.testing.assert_array_equal(out, ref)
