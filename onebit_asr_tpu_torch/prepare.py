"""`python -m onebit_asr_tpu_torch.prepare` — data preparation: ingest,
tokenizer, export_spm, tokenize, cmvn, features, lm, all (see cli/prepare.py)."""

from onebit_asr_tpu_torch.cli.prepare import main

if __name__ == "__main__":
    raise SystemExit(main())
