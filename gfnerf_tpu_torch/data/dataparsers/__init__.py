"""Port of ``gfnerf_tpu.data.dataparsers``: the base types and the
registry of the parsers ported so far (nerfstudio, blender, the minimal
npz parser, instant-ngp, and the dynamic formats dnerf and dycheck).  The
JAX package's other parsers raise "not ported"."""

from __future__ import annotations

from pathlib import Path

# the JAX package's registered parsers that have no port yet
NOT_PORTED = ("scannet", "sdfstudio", "phototourism", "sitcoms3d",
              "arkitscenes", "nuscenes")


def registry():
    """name -> (ParserClass, ConfigClass) of the ported parsers."""
    from gfnerf_tpu_torch.data.dataparsers.blender_parser import (
        BlenderDataParser, BlenderDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers.extra_parsers import (
        DNeRFDataParser, DNeRFDataParserConfig, DycheckDataParser,
        DycheckDataParserConfig, InstantNGPDataParser,
        InstantNGPDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers.nerfstudio_parser import (
        NerfstudioDataParser, NerfstudioDataParserConfig)

    return {
        "nerfstudio": (NerfstudioDataParser, NerfstudioDataParserConfig),
        "blender": (BlenderDataParser, BlenderDataParserConfig),
        "minimal": (MinimalDataParser, MinimalDataParserConfig),
        "instant-ngp": (InstantNGPDataParser, InstantNGPDataParserConfig),
        "dnerf": (DNeRFDataParser, DNeRFDataParserConfig),
        "dycheck": (DycheckDataParser, DycheckDataParserConfig),
    }


def build_dataparser(name: str, data: Path, scale_factor: float = None):
    """The dataparser ``name`` over the dataset ``data`` (with
    ``scale_factor`` where its config has one)."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataparser {name!r} is not ported; ported: {sorted(registry())}")
    reg = registry()
    if name not in reg:
        raise ValueError(
            f"unknown dataparser {name!r}; available: {sorted(reg)}")
    parser_cls, cfg_cls = reg[name]
    cfg = cfg_cls(data=Path(data))
    if scale_factor is not None and hasattr(cfg, "scale_factor"):
        cfg.scale_factor = scale_factor
    return parser_cls(cfg)
