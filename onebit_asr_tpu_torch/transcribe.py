"""`python -m onebit_asr_tpu_torch.transcribe` — serving: a trained run +
audio -> text (see cli/transcribe.py)."""

from onebit_asr_tpu_torch.cli.transcribe import main

if __name__ == "__main__":
    raise SystemExit(main())
