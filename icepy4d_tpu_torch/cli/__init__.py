"""The port's command lines, counterparts of the JAX package's
`scripts/*.py`:

    python -m icepy4d_tpu_torch <command> [arguments] [--device DEV]

Each command keeps its script's flags, defaults and printed lines, and
adds `--device` (default: the card, and an error without one; `cpu`
runs the plain PyTorch path). Each module has `main(argv=None)`, so a
caller can run a command in-process.
"""

from __future__ import annotations

import importlib
import sys

# command -> what it does, in the order `--help` lists them
COMMANDS = {
    "run_pipeline": "run the multi-epoch 4D pipeline from a YAML config",
    "build_dem": "build a DSM (and a GeoTIFF) from a PLY point cloud",
    "update_dem": "merge a DSM into a base DEM and report volume change",
    "track_targets": "track GCP targets across images by OC template "
                     "matching",
    "volume_variations": "volume variation time series between epoch "
                         "clouds",
    "voxelization": "voxelize epoch point clouds to a fixed grid",
    "extract_section": "detect the glacier top border and its time series",
    "plot_sections": "plot cross sections of epoch point clouds",
    "pcd_rototranslation": "transform point clouds between the Belvedere "
                           "local and UTM frames",
    "dynamic_visualization": "render an epoch-by-epoch animation of the "
                             "clouds",
}


def usage() -> str:
    width = max(map(len, COMMANDS))
    lines = ["usage: python -m icepy4d_tpu_torch <command> [arguments] "
             "[--device DEVICE]", "", "commands:"]
    lines += [f"  {name:<{width}}  {doc}" for name, doc in COMMANDS.items()]
    lines += ["", "python -m icepy4d_tpu_torch <command> --help shows a "
              "command's flags."]
    return "\n".join(lines)


def main(argv=None):
    """Run the command named by argv[0] with the rest of argv; returns
    what the command's main returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(usage())
        return None
    name, rest = argv[0], argv[1:]
    if name not in COMMANDS:
        sys.exit(f"unknown command {name!r}\n\n{usage()}")
    return importlib.import_module(f"icepy4d_tpu_torch.cli.{name}").main(rest)
