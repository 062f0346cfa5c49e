"""`python -m plonkit_tpu_torch` == the port's plonkit-compatible CLI
(console script `plonkit-tpu-torch`)."""

from .cli import main

if __name__ == "__main__":
    main()
