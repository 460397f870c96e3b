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
PORT_FILES = sorted(p for p in (REPO / "intact_tpu_torch").rglob("*.py") if "_build" not in p.parts) + [
    REPO / "chip_smoke.py"]


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


def test_port_files_found():
    assert len(PORT_FILES) > 15


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


@pytest.mark.parametrize("entry", ["policy", "init", "server", "pi0fast_policy", "pi0fast_init", "mvla_policy",
                                   "mvla_init"])
def test_entry_points_raise_without_cuda_unless_given_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from intact_tpu_torch import serve
    from intact_tpu_torch.models.pi0 import model
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.models.pi0fast import Pi0FASTConfig
    from intact_tpu_torch.models.pi0fast import model as fast
    from intact_tpu_torch.models.mvla import MVLAConfig
    from intact_tpu_torch.models.mvla import model as mvla

    cfg, fcfg, mcfg = Pi0Config.tiny(), Pi0FASTConfig.tiny(), MVLAConfig.tiny()
    call = {
        "policy": lambda **kw: Pi0Policy(cfg, tokenizer_path="hash", **kw),
        "init": lambda **kw: model.init(cfg, **kw),
        "server": lambda **kw: serve.build_server(cfg, port=0, **kw),
        "pi0fast_policy": lambda **kw: Pi0Policy(fcfg, tokenizer_path="hash", model_module=fast, **kw),
        "pi0fast_init": lambda **kw: fast.init(fcfg, **kw),
        "mvla_policy": lambda **kw: Pi0Policy(mcfg, tokenizer_path="hash", model_module=mvla, **kw),
        "mvla_init": lambda **kw: mvla.init(mcfg, **kw),
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
