"""`python -m onebit_asr_tpu_torch.serve` — the multiplexed streaming ASR
daemon (NDJSON over stdio or TCP; cli/serve.py)."""

from onebit_asr_tpu_torch.cli.serve import main

if __name__ == "__main__":
    raise SystemExit(main())
