"""`python -m multiposenet_tpu_torch eval|predict ...` (see cli.py)."""

from multiposenet_tpu_torch.cli import main

if __name__ == "__main__":
    main()
