"""Fine-tuning on one card: the next-token train step with AdamW
(``trainer.py``) and step-directory checkpoints that the provider serves
back (``checkpoint.py``).

Port of ``langstream_tpu/training``; the sharded mesh is not ported
(ROADMAP.md, A10).
"""

from langstream_tpu_torch.training.trainer import TrainConfig, Trainer

__all__ = ["Trainer", "TrainConfig"]
