"""`python -m lightgbm_tpu_torch config=train.conf` — the CLI entry point
(the reference's src/main.cpp)."""
import sys

from .application import main

if __name__ == "__main__":
    sys.exit(main())
