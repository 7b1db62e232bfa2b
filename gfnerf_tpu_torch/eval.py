"""Compute eval metrics from a trained checkpoint.

The port's counterpart of ``scripts/eval.py`` (the reference's ComputePSNR,
eval.py:32-43): it loads a training run's ``config.json`` and latest
checkpoint, renders every eval image and writes one JSON file with the
mean PSNR, SSIM, LPIPS proxy, rays/s and fps:

  python -m gfnerf_tpu_torch.eval --load-config RUN/config.json
      [--output-path eval_output.json]
      [--dataparser {minimal,blender,nerfstudio,instant-ngp,dnerf,dycheck}]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gfnerf_tpu_torch.train import DATAPARSERS


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--output-path", type=Path,
                        default=Path("eval_output.json"))
    parser.add_argument("--dataparser", default=None,
                        choices=DATAPARSERS,
                        help="default: guessed from the run's data "
                             "directory")
    args = parser.parse_args(argv)

    from gfnerf_tpu_torch.utils.eval_utils import eval_setup

    config, trainer = eval_setup(args.load_config, args.dataparser)
    step = int(trainer.pipeline.state.step)
    metrics = trainer.pipeline.get_average_eval_image_metrics(step)
    out = {
        "experiment_name": config.experiment_name,
        "method_name": config.method_name,
        "checkpoint": str(config.load_dir),
        "results": metrics,
    }
    args.output_path.parent.mkdir(parents=True, exist_ok=True)
    args.output_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
