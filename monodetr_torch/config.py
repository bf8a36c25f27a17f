"""YAML config loading, and the shipped model as a Python dict.

`load_config` reads a config of the reference's schema
(`configs/monodetr.yaml`): one dict with `dataset` / `model` / `optimizer` /
`lr_scheduler` / `trainer` / `tester` sections plus `random_seed` /
`model_name`, passed down as plain dicts with defaults resolved at use
sites (a copy of the JAX package's config.py).

`MONODETR_MODEL` is the `model:` section of configs/monodetr.yaml as
yaml.safe_load reads it (so `depth_min` stays the string '1e-3', which
build_monodetr converts); a test holds the two equal.  It lets a run build
the shipped model where PyYAML is not installed.
"""

MONODETR_MODEL = {
    "num_classes": 3, "return_intermediate_dec": True,
    "msda_impl": "fused", "msda_window": 6, "dec_msda_impl": "sep",
    "dtype": "bf16", "remat": False,
    "backbone": "resnet50", "train_backbone": True, "num_feature_levels": 4,
    "dilation": False, "position_embedding": "sine", "masks": False,
    "mode": "LID", "num_depth_bins": 80, "depth_min": "1e-3", "depth_max": 60.0,
    "with_box_refine": True, "two_stage": False, "use_dab": False, "use_dn": False,
    "two_stage_dino": False, "init_box": False,
    "enc_layers": 3, "dec_layers": 3, "hidden_dim": 256, "dim_feedforward": 256,
    "dropout": 0.1, "nheads": 8, "num_queries": 50, "enc_n_points": 4,
    "dec_n_points": 4,
    "scalar": 5, "label_noise_scale": 0.2, "box_noise_scale": 0.4, "num_patterns": 0,
    "aux_loss": True,
    "cls_loss_coef": 2, "focal_alpha": 0.25, "bbox_loss_coef": 5, "giou_loss_coef": 2,
    "3dcenter_loss_coef": 10, "dim_loss_coef": 1, "angle_loss_coef": 1,
    "depth_loss_coef": 1, "depth_map_loss_coef": 1,
    "set_cost_class": 2, "set_cost_bbox": 5, "set_cost_giou": 2, "set_cost_3dcenter": 10,
}


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
