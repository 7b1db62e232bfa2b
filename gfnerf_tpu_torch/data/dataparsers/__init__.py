"""Port of ``gfnerf_tpu.data.dataparsers``: the base types and the
registry of every parser the JAX package registers (nerfstudio, blender,
the minimal npz parser, and the formats of ``extra_parsers``)."""

from __future__ import annotations

from pathlib import Path


def registry():
    """name -> (ParserClass, ConfigClass), under the JAX package's names."""
    from gfnerf_tpu_torch.data.dataparsers import extra_parsers as ep
    from gfnerf_tpu_torch.data.dataparsers.blender_parser import (
        BlenderDataParser, BlenderDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)
    from gfnerf_tpu_torch.data.dataparsers.nerfstudio_parser import (
        NerfstudioDataParser, NerfstudioDataParserConfig)

    return {
        "nerfstudio": (NerfstudioDataParser, NerfstudioDataParserConfig),
        "blender": (BlenderDataParser, BlenderDataParserConfig),
        "minimal": (MinimalDataParser, MinimalDataParserConfig),
        "instant-ngp": (ep.InstantNGPDataParser, ep.InstantNGPDataParserConfig),
        "dnerf": (ep.DNeRFDataParser, ep.DNeRFDataParserConfig),
        "scannet": (ep.ScanNetDataParser, ep.ScanNetDataParserConfig),
        "sdfstudio": (ep.SDFStudioDataParser, ep.SDFStudioDataParserConfig),
        "phototourism": (ep.PhototourismDataParser,
                         ep.PhototourismDataParserConfig),
        "sitcoms3d": (ep.Sitcoms3DDataParser, ep.Sitcoms3DDataParserConfig),
        "arkitscenes": (ep.ARKitScenesDataParser,
                        ep.ARKitScenesDataParserConfig),
        "nuscenes": (ep.NuScenesDataParser, ep.NuScenesDataParserConfig),
        "dycheck": (ep.DycheckDataParser, ep.DycheckDataParserConfig),
    }


def build_dataparser(name: str, data: Path, scale_factor: float = None):
    """The dataparser ``name`` over the dataset ``data`` (with
    ``scale_factor`` where its config has one)."""
    reg = registry()
    if name not in reg:
        raise ValueError(
            f"unknown dataparser {name!r}; available: {sorted(reg)}")
    parser_cls, cfg_cls = reg[name]
    cfg = cfg_cls(data=Path(data))
    if scale_factor is not None and hasattr(cfg, "scale_factor"):
        cfg.scale_factor = scale_factor
    return parser_cls(cfg)
