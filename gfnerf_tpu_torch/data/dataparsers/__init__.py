"""Port of ``gfnerf_tpu.data.dataparsers``: the base types and the minimal
npz parser (the one dataparser whose images need no decoding)."""

from __future__ import annotations

from pathlib import Path


def build_dataparser(name: str, data: Path):
    """The dataparser ``name`` over the dataset directory ``data``."""
    if name != "minimal":
        raise NotImplementedError(
            f"dataparser {name!r} is not ported (it decodes images from "
            "disk); use 'minimal'")
    from gfnerf_tpu_torch.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)

    return MinimalDataParser(MinimalDataParserConfig(data=Path(data)))
