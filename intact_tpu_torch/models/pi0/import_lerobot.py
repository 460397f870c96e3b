"""Import a LeRobot PI0Policy safetensors checkpoint into a port step dir.

The released INT-ACT policies (e.g. `juexzz/INTACT-pi0-finetune-bridge`)
become checkpoints that `Pi0Policy.load` and `Pi0PolicyWrapper.switch_model`
(the server role's `eval_cfg.pretrained_model_path`) read:

  python -m intact_tpu_torch.models.pi0.import_lerobot \\
      --src /path/to/lerobot_ckpt_dir --out /ckpts/pi0_bridge --step 22695

writes <out>/step_<step>/ (params.pt, auxiliary_data.json) on the host CPU;
no card is needed. --tiny takes `Pi0Config.tiny()` (tests).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="dir or model.safetensors path")
    ap.add_argument("--out", required=True, help="checkpoint root (step_{n} created)")
    ap.add_argument("--step", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="tiny config (tests)")
    args = ap.parse_args(argv)

    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.hf_import import check_shapes
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0.convert import load_safetensors_checkpoint
    from intact_tpu_torch.train import checkpoint as ckpt

    cfg = Pi0Config.tiny() if args.tiny else Pi0Config.bridge()
    params = check_shapes(load_safetensors_checkpoint(args.src, cfg), pi0.init(cfg, device="meta"))
    path = ckpt.save_checkpoint(args.out, params, step=args.step, aux={"source": str(args.src)})
    n_params = sum(x.numel() for x in cm.tree_leaves(params))
    print(f"imported {n_params / 1e9:.2f}B params -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
