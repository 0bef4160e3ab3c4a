"""Self-training of SuperPoint, LightGlue (homography stage and the
real-correspondence fine-tune) and ALIKED, the counterpart of
`icepy4d_tpu/training/`.

Each trainer takes `device=None` (the card) or runs on the device of the
model it is given, and returns what the JAX trainer returns with a
PyTorch state dict in place of the flax tree;
`models.convert.*_tree_from_state_dict` and `save_params` write it as a
checkpoint both packages load. `python -m icepy4d_tpu_torch.training`
is the command line.
"""

from icepy4d_tpu_torch.training.aliked_train import train_aliked  # noqa: F401
from icepy4d_tpu_torch.training.lightglue_train import (  # noqa: F401
    collect_epoch_pairs,
    evaluate_matching,
    homography_to_explicit,
    make_correspondence_dataset,
    make_lightglue_dataset,
    train_lightglue,
)
from icepy4d_tpu_torch.training.superpoint_train import (  # noqa: F401
    homographic_adaptation,
    train_superpoint,
)
