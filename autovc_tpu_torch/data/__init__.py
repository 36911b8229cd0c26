"""Data: the train.pkl, metadata.pkl and results manifests, the metadata builder, the
in-RAM utterance dataset and its batch iterator, and the device
prefetcher."""

from autovc_tpu_torch.data.dataset import BatchIterator, UtteranceDataset
from autovc_tpu_torch.data.manifest import (ConversionSpec, SpeakerEntry, load_conversion_metadata, load_results,
                                            load_train_manifest, save_conversion_metadata, save_results,
                                            save_train_manifest)

__all__ = ["BatchIterator", "ConversionSpec", "SpeakerEntry", "UtteranceDataset", "load_conversion_metadata",
           "load_results", "load_train_manifest", "save_conversion_metadata", "save_results", "save_train_manifest"]
