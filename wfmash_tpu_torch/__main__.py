import os
import sys

# the JAX package's device mapping stage is not ported: keep mapping on
# its native host stages (this also skips its device round-trip probe)
os.environ["WFMASH_TPU_DEVICE_L1"] = "0"

from .cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
