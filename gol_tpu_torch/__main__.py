"""`python -m gol_tpu_torch` — the headless CLI of `gol_tpu_torch.main`."""

import sys

from gol_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main())
