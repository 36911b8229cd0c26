"""Training data: train.pkl manifests, the in-RAM utterance dataset and its
batch iterator, and the device prefetcher."""

from autovc_tpu_torch.data.dataset import BatchIterator, UtteranceDataset
from autovc_tpu_torch.data.manifest import SpeakerEntry, load_train_manifest, save_train_manifest

__all__ = ["BatchIterator", "SpeakerEntry", "UtteranceDataset", "load_train_manifest", "save_train_manifest"]
