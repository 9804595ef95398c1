"""Dataset metadata registry (JAX: data/registry.py).

``get_dataset_meta(name)`` returns the dataset CLASS (class attributes:
num_categories, default_resolution, mean/std, max_objs, num_joints,
rest_focal_length) without loading annotations, as the reference uses
the class object (detector.py:39-47, opts.py:330-341).
"""

from __future__ import annotations


def get_dataset_meta(name: str, cfg=None):
    from centertrack_tpu_torch.data.datasets import get_dataset
    cls = get_dataset(name)
    if name == "custom" and cfg is not None and cfg.num_classes > 0:
        class _CustomMeta(cls):
            num_categories = cfg.num_classes
            default_resolution = [cfg.input_h, cfg.input_w]
        return _CustomMeta
    return cls
