"""Training-metric sinks: jsonl always, wandb when installed and configured.

Port of `handsonvlm_tpu/utils/metrics_writer.py`. The reference logged
train losses and eval ADE/FDE/WDE to wandb (handsonvlm.py:195-198,
handsonvlm_trainer.py:302-306). Here metrics arrive as step dicts from the
train loop and fan out to:

- metrics.jsonl (always; the source of truth);
- wandb, if importable AND configured (WANDB_API_KEY/WANDB_MODE=offline).

The JAX package's tensorboard sink is not carried over: importing torch's
SummaryWriter loads TensorFlow where that is installed, and with it JAX,
which the port must not load.

Only rank 0 writes (the rank of torch.distributed when it is initialised).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from handsonvlm_torch.train.loader import process_index_count


class MetricsWriter:
    def __init__(self, out_dir: str, run_name: Optional[str] = None):
        self.is_main = process_index_count()[0] == 0
        self.jsonl = None
        self.wandb = None
        if not self.is_main:
            return
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        try:
            import wandb
        except ImportError:
            return
        if wandb.run is None and (os.environ.get("WANDB_API_KEY")
                                  or os.environ.get("WANDB_MODE")):
            # run name derived from the output dir, like the reference
            # (handsonvlm/train/train.py:197-204)
            wandb.init(project=os.environ.get("WANDB_PROJECT", "handsonvlm_torch"),
                       name=run_name or os.path.basename(os.path.abspath(out_dir)),
                       dir=out_dir)
        self.wandb = wandb if wandb.run is not None else None

    def log(self, metrics: Dict, step: int) -> None:
        if not self.is_main:
            return
        rec = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        rec["step"] = step
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(rec, step=step)

    def close(self) -> None:
        if self.jsonl is not None:
            self.jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()
