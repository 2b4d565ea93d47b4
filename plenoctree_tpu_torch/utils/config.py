"""The framework's flags on argparse, and a flat YAML config reader.

Port of plenoctree_tpu/utils/config.py: the same flag names, defaults and
enums, without absl or pyyaml. Boolean flags take the absl spellings
(`--flag`, `--noflag`, `--flag=false`).

`--config <file>` names a YAML file (`.yaml` may be left off) whose keys
override flags by name; unknown keys raise. The repo's configs hold only
top-level `key: value` scalars, so a small reader with PyYAML's scalar
rules (YAML 1.1: `1e-3` without a dot stays a string) replaces pyyaml; a
nested value raises. One deliberate difference from the JAX package: a
flag given explicitly on the command line wins over the config file, so
`--config nerf_sh/config/blender --dataset synthetic` evaluates on the
synthetic scene.
"""

import argparse
import copy
import re
import sys
import types
from os import path

# name -> (default, help, enum).
_FLAG_DEFS = {}


def _flag(name, default, help_str, enum=None):
    _FLAG_DEFS[name] = (default, help_str, enum)


# Paths / config
_flag("train_dir", None, "where to store ckpts and logs")
_flag("data_dir", None, "input data directory")
_flag("config", None, "YAML config file overriding flag values by name")

# Dataset
_flag("dataset", "blender", "dataset loader type", enum=["blender", "llff", "nsvf", "synthetic"])
_flag("image_batching", False, "sample rays in a batch from different images")
_flag("white_bkgd", True, "composite onto white background (blender/nsvf)")
_flag("batch_size", 1024, "number of rays per training mini-batch (global)")
_flag("factor", 4, "image downsample factor, 0 for none")
_flag("spherify", False, "set for spherical 360 scenes (llff)")
_flag("render_path", False, "render generated path (llff only)")
_flag("llffhold", 8, "hold out every 1/N images as llff test set")

# Model
_flag("model", "nerf", "name of the model to use")
_flag("near", 2.0, "near clip of volumetric rendering")
_flag("far", 6.0, "far clip of volumetric rendering")
_flag("net_depth", 8, "depth of the trunk MLP")
_flag("net_width", 256, "width of the trunk MLP")
_flag("net_depth_condition", 1, "depth of the view-conditioned branch")
_flag("net_width_condition", 128, "width of the view-conditioned branch")
_flag("weight_decay_mult", 0.0, "weight decay multiplier")
_flag("skip_layer", 4, "skip connection every N trunk layers")
_flag("num_rgb_channels", 3, "number of color channels")
_flag("num_sigma_channels", 1, "number of density channels")
_flag("randomized", True, "use randomized stratified sampling")
_flag("min_deg_point", 0, "min posenc degree for points")
_flag("max_deg_point", 10, "max posenc degree for points")
_flag("deg_view", 4, "posenc degree for view directions")
_flag("num_coarse_samples", 64, "samples per ray, coarse pass")
_flag("num_fine_samples", 128, "samples per ray, fine pass")
_flag("use_viewdirs", True, "condition colors on view direction")
_flag("sh_deg", -1, "SH output up to given degree; -1 disables")
_flag("sg_dim", -1, "spherical-gaussian output dimension; -1 disables")
_flag("sg_global", True, "share SG lambda/mu globally across points")
_flag("noise_std", None, "std of density regularization noise")
_flag("lindisp", False, "sample linearly in disparity rather than depth")
_flag("net_activation", "relu", "MLP activation name")
_flag("rgb_activation", "sigmoid", "output color activation name")
_flag("sigma_activation", "relu", "output density activation name")
_flag("legacy_posenc_order", False, "legacy TF posenc feature ordering")

# Train
_flag("lr_init", 5e-4, "initial learning rate")
_flag("lr_final", 5e-6, "final learning rate")
_flag("lr_delay_steps", 0, "steps to delay full learning rate")
_flag("lr_delay_mult", 1.0, "lr multiplier during the delay window")
_flag("max_steps", 1000000, "number of optimization steps")
_flag("save_every", 10000, "steps between checkpoints")
_flag("print_every", 1000, "steps between metric reports")
_flag("render_every", 20000, "steps between test-view renders")
_flag("gc_every", 5000, "steps between manual gc passes")
_flag("sparsity_weight", 1e-3, "sparsity loss weight")
_flag("sparsity_length", 0.05, "sparsity loss alpha length")
_flag("sparsity_npoints", 10000, "number of sparsity-loss sample points")
_flag("sparsity_radius", 1.5, "sparsity sampling box half side length")

# Eval
_flag("eval_once", True, "evaluate once vs. poll for new checkpoints")
_flag("save_output", True, "save predicted images to disk")
_flag("chunk", 8192, "rays/points per inference chunk")
_flag("approx_eval_skip", 1, "evaluate every x-th test image only")

# Octree renderer
_flag("renderer_step_size", 1e-4, "octree render step epsilon (1e-3 fast / 1e-5 high)")
_flag("no_early_stop", False, "disable early ray termination in octree render")
_flag("max_segments", 0, "octree march segment bound (0 = auto, 3*2^depth)")
_flag(
    "fast_eval",
    False,
    "evaluate octrees with the tile renderer (serving path; hit ordering "
    "within a 128-row chunk is mean-direction approximate) instead of the "
    "exact march oracle",
)
_flag(
    "shard_devices",
    0,
    "with --fast_eval: shard the tile renderer over this many devices "
    "(0/1 = single device)",
)

# Octree extraction (parity: octree/extraction.py:66-176)
_flag("center", "0 0 0", "volume center 'x y z' or single number")
_flag("radius", "1.5", "volume 1/2 side length, 'x y z' or single number")
_flag("alpha_thresh", 0.01, "alpha threshold for sigma masking")
_flag("max_refine_prop", 0.5, "max proportion of cells to refine")
_flag("z_min", None, "discard points below this z (NDC use)")
_flag("z_max", None, "discard points above this z (NDC use)")
_flag("tree_branch_n", 2, "tree branch factor (2 = octree)")
_flag("init_grid_depth", 8, "initial grid depth (2^(x+1) voxel grid)")
_flag("samples_per_cell", 8, "3D antialiasing samples per leaf")
_flag("is_jaxnerf_ckpt", False, "checkpoint is original JaxNeRF layout (auto-detected; kept for CLI parity)")
_flag("masking_mode", "weight", "octree build mask source", enum=["sigma", "weight"])
_flag("weight_thresh", 0.001, "weight threshold to keep a voxel")
_flag("projection_samples", 10000, "rays sampled for SH projection")
_flag("bbox_from_data", False, "use dataset bounding box (NSVF bbox.txt)")
_flag("data_bbox_scale", 1.0, "scale factor on the dataset bbox")
_flag("autoscale", False, "auto-scale bbox to sigma support")
_flag("bbox_cube", False, "force the bbox to a cube")
_flag("bbox_scale", 1.0, "final scale factor on the bbox")
_flag("scale_alpha_thresh", 0.01, "alpha threshold during autoscale")
_flag(
    "point_chunk",
    0,
    "points per extraction device dispatch (0 = auto: max(chunk, 2^20) on a GPU, "
    "max(chunk, 2^17) on the CPU)",
)

# Profiling
_flag("profile_start_step", 0, "step to start a profiler trace (0 = off)")
_flag("profile_steps", 5, "number of steps to trace")

# Parallelism
_flag("mesh_shape", "", "comma ints: mesh axis sizes (data[,model]); empty = all-data")
_flag("param_dtype", "float32", "parameter dtype")
_flag("compute_dtype", "float32", "activation compute dtype (float32|bfloat16)")
_flag("use_pallas", False, "use the fused kernels where available")

_FLOAT_FLAGS = ("noise_std", "z_min", "z_max")


def default_config(**overrides):
    """A mutable flag namespace with all defaults, for tests/library use."""
    cfg = types.SimpleNamespace(**{k: copy.copy(v[0]) for k, v in _FLAG_DEFS.items()})
    for k, v in overrides.items():
        if k not in _FLAG_DEFS:
            raise ValueError(f"Unknown config key: {k}")
        setattr(cfg, k, v)
    return cfg


def _parse_bool(text):
    low = str(text).lower()
    if low in ("1", "true", "t", "yes", "y"):
        return True
    if low in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def add_bool_flag(parser, name, default, help_str):
    """A CLI-local boolean flag with the absl spellings (`--name`,
    `--noname`, `--name=false`)."""
    parser.add_argument(
        f"--{name}", nargs="?", const=True, default=default, type=_parse_bool,
        help=f"{help_str} (default {default})",
    )
    parser.add_argument(f"--no{name}", dest=name, action="store_const", const=False,
                        help=argparse.SUPPRESS)


def add_flags(parser, extra=()):
    """Register every framework flag on an argparse parser. Every flag's
    parser default is None so that `parse_flags` can tell an explicit flag
    from a default. `extra` names are skipped: the CLI defines its own
    versions (as the JAX package's define_flags(extra=...))."""
    for name, (default, help_str, enum) in _FLAG_DEFS.items():
        if name in extra:
            continue
        if isinstance(default, bool):
            parser.add_argument(
                f"--{name}", nargs="?", const=True, default=None,
                type=_parse_bool, help=f"{help_str} (default {default})",
            )
            parser.add_argument(
                f"--no{name}", dest=name, action="store_const", const=False,
                default=None, help=argparse.SUPPRESS,
            )
        else:
            if enum is not None:
                typ = str
            elif isinstance(default, int):
                typ = int
            elif isinstance(default, float) or name in _FLOAT_FLAGS:
                typ = float
            else:
                typ = str
            parser.add_argument(
                f"--{name}", type=typ, default=None, choices=enum,
                help=f"{help_str} (default {default})",
            )


def parse_flags(parser, argv=None):
    """Parse argv into a flag namespace: defaults, then the `--config`
    file, then the flags given explicitly on the command line."""
    ns = parser.parse_args(sys.argv[1:] if argv is None else argv)
    explicit = {k: v for k, v in vars(ns).items() if v is not None}
    cfg = default_config()
    for k, v in vars(ns).items():
        if k not in _FLAG_DEFS:
            setattr(cfg, k, v)  # CLI-local flags keep their parser defaults
    cfg.config = explicit.get("config")
    update_flags(cfg)
    for k, v in explicit.items():
        setattr(cfg, k, v)
    return cfg


def update_flags(args):
    """Merge the YAML file named by args.config into args.

    Unknown keys raise, matching the reference's strict validation.
    Accepts both bare and .yaml paths.
    """
    if getattr(args, "config", None) is None:
        return args
    pth = args.config
    if not pth.endswith(".yaml"):
        pth = pth + ".yaml"
    with open(path.expanduser(pth), "r") as fin:
        configs = read_flat_yaml(fin.read(), pth)
    invalid = [k for k in configs if not hasattr(args, k) and k not in _FLAG_DEFS]
    if invalid:
        raise ValueError(f"Invalid args {invalid} in {pth}.")
    for k, v in configs.items():
        setattr(args, k, v)
    return args


# PyYAML's (YAML 1.1) implicit scalar resolvers for the types a flat
# config holds.
_YAML_BOOL = {
    "yes": True, "Yes": True, "YES": True, "no": False, "No": False,
    "NO": False, "true": True, "True": True, "TRUE": True, "false": False,
    "False": False, "FALSE": False, "on": True, "On": True, "ON": True,
    "off": False, "Off": False, "OFF": False,
}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_YAML_SPECIAL_FLOAT = {
    ".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
    "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
    "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf"),
    ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan"),
}


def _yaml_scalar(text):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _YAML_NULL:
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _YAML_SPECIAL_FLOAT:
        return _YAML_SPECIAL_FLOAT[text]
    return text


def read_flat_yaml(text, name="<config>"):
    """Parse a YAML document of top-level `key: scalar` lines into a dict."""
    out = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split(" #", 1)[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#") or line == "---":
            continue
        key, sep, value = line.partition(":")
        value = value.strip()
        if (
            line[0].isspace()
            or not sep
            or line.startswith("- ")
            or value[:1] in ("[", "{", "|", ">", "&", "*", "!")
        ):
            raise ValueError(
                f"{name}:{lineno}: only flat 'key: scalar' lines are "
                f"supported, got {raw!r}"
            )
        out[key.strip()] = _yaml_scalar(value)
    return out
