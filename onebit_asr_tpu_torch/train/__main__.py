"""`python -m onebit_asr_tpu_torch.train` — 3-branch QAT training (see cli/train.py)."""

from onebit_asr_tpu_torch.cli.train import main

if __name__ == "__main__":
    raise SystemExit(main())
