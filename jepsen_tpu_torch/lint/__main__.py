"""`python -m jepsen_tpu_torch.lint` — the direct entry point (the CLI's
`lint` subcommand routes to the same `main`)."""
import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
