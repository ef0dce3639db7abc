"""Data layer: manifest-based LibriSpeech pipeline (data/librispeech.py),
tokenizer (data/text.py, data/spm.py), length bucketing, producer-thread
prefetch, and the synthetic backend. Same exports as
onebit_asr_tpu/data/__init__.py."""

from onebit_asr_tpu_torch.data.dummy import DummyDataModule
from onebit_asr_tpu_torch.data.manifest import (
    ShardCache,
    Utterance,
    bucket_boundaries,
    bucketed_batches,
    read_manifest,
    write_manifest,
)
from onebit_asr_tpu_torch.data.prefetch import prefetch

__all__ = [
    "DummyDataModule",
    "ShardCache",
    "Utterance",
    "bucket_boundaries",
    "bucketed_batches",
    "read_manifest",
    "write_manifest",
    "prefetch",
]
