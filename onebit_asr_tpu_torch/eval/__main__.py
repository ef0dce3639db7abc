"""`python -m onebit_asr_tpu_torch.eval` — multi-precision evaluation (see cli/evaluate.py)."""

from onebit_asr_tpu_torch.cli.evaluate import main

if __name__ == "__main__":
    raise SystemExit(main())
