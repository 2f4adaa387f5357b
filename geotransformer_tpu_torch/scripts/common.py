r"""What the port's scripts share: the ``--device`` option and the loader's
pipeline keywords of a configuration."""

import os

import torch


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card, the default) or cpu")


def resolve_device(name):
    """``name``, after checking that a CUDA device exists where one is asked
    for: a script never falls back to the CPU on its own. Under a launcher
    (``LOCAL_RANK`` set), ``cuda`` is this process's card,
    ``cuda:LOCAL_RANK``."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} needs a CUDA device, and torch sees none; "
                           "pass --device cpu to run on the CPU")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return name


def pipeline_config(cfg, stage_caps=None, **extra):
    """The keywords of ``prepare_pair`` for ``cfg`` (its caps unless
    ``stage_caps`` is given), plus ``extra``."""
    bb, caps = cfg.backbone, cfg.caps
    return dict(
        num_stages=bb.num_stages,
        voxel_size=bb.init_voxel_size,
        search_radius=bb.init_radius,
        neighbor_limits=caps.neighbor_limits,
        stage_caps=caps.stage_caps if stage_caps is None else stage_caps,
        input_dim=bb.input_dim,
        neighbor_splits=caps.neighbor_splits,
        subsampling_splits=caps.subsampling_splits,
        **extra,
    )
