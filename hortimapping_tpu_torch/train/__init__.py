"""DeepSDF training on the card (counterpart of `hortimapping_tpu/train`)."""

from hortimapping_tpu_torch.train.deepsdf import (  # noqa: F401
    TrainResult,
    load_sdf_samples,
    train_deepsdf,
)
