"""Entry point: ``python -m ray_tpu_torch <command>`` (the reference's
`ray` CLI; ``ray_tpu_torch.scripts``)."""

import sys

from ray_tpu_torch.scripts import main

if __name__ == "__main__":
    sys.exit(main())
