"""wandb facade (a copy of intact_tpu/utils/wandb_gate.py): the real wandb
when installed and enabled, a silent no-op run otherwise. Run ids still mint
and persist through checkpoints, so a resume keeps one wandb run when the
library is present.
"""

from __future__ import annotations

import logging
import uuid

log = logging.getLogger("intact_tpu_torch.wandb")


class _NoopRun:
    id: str

    def __init__(self, run_id: str):
        self.id = run_id

    def log(self, *a, **k):
        pass

    def finish(self):
        pass


def init(enabled: bool, project: str, name: str | None = None,
         entity: str | None = None, run_id: str | None = None, config=None):
    """-> object with .id / .log(dict, step=) / .finish()."""
    run_id = run_id or uuid.uuid4().hex[:8]
    if not enabled:
        return _NoopRun(run_id)
    try:
        import wandb

        return wandb.init(
            project=project, name=name, entity=entity, id=run_id,
            resume="allow", config=config,
        )
    except ImportError:
        log.warning("use_wandb=True but wandb is not installed; logging to noop")
        return _NoopRun(run_id)
