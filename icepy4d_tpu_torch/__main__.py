"""`python -m icepy4d_tpu_torch <command> ...`: see `icepy4d_tpu_torch.cli`."""

from icepy4d_tpu_torch.cli import main

if __name__ == "__main__":
    main()
