"""Serve the interactive web viewer for a trained checkpoint.

The port's counterpart of ``scripts/viewer.py`` (the reference's ``--vis
viewer`` websocket stack): loads the run and serves the orbit-control
page at http://HOST:PORT.

  python -m gfnerf_tpu_torch.viewer --load-config RUN/config.json
      [--port 7007] [--host 127.0.0.1] [--dataparser NAME]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from gfnerf_tpu_torch.train import DATAPARSERS


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address; pass 0.0.0.0 to expose the "
                             "viewer beyond this host")
    parser.add_argument("--dataparser", default=None, choices=DATAPARSERS,
                        help="default: guessed from the run's data "
                             "directory")
    args = parser.parse_args(argv)

    from gfnerf_tpu_torch.exporter.exporter import train_outputs
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    _, trainer = eval_setup(args.load_config, args.dataparser)
    pipeline = trainer.pipeline
    pos = train_outputs(pipeline).cameras.camera_to_worlds[:, :, 3]
    radius = float(np.linalg.norm(pos, axis=1).mean())
    ViewerServer(pipeline, port=args.port, host=args.host,
                 default_radius=radius,
                 save_dir=args.load_config.parent).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
