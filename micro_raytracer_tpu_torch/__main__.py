"""``python -m micro_raytracer_tpu_torch`` == the ``raytrace`` CLI."""

import sys

from .frontends.cli import main

sys.exit(main())
