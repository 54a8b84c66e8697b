"""mpitree_tpu_torch.ingest — out-of-core streaming ingest.

Counterpart of ``mpitree_tpu/ingest/``. Without it ``fit(X, y)`` needs the
raw feature matrix whole in one host's RAM before binning. Here input
arrives in host chunks (in-memory arrays re-chunked, memory-mapped
``.npy`` shards, ``.npz`` shards, or chunk iterators); one pass fits a
mergeable per-feature sketch (``sketch.py``, bit-identical to
``ops.binning.bin_dataset``'s edges while exact), and a second bins each
chunk against the packed edges and copies it straight into its shard on
the fit's devices (``place.py``): the raw matrix never exists on any
host, and the binned one only on the devices, one shard each.

Estimator surface: ``DecisionTreeClassifier().fit(StreamedDataset...)``
(or ``fit(dataset=...)``), and the same on every estimator; datasets come
from :meth:`StreamedDataset.from_arrays`, :meth:`~StreamedDataset.from_npy`,
:meth:`~StreamedDataset.from_npz` and :meth:`~StreamedDataset.from_chunks`.
"""

from mpitree_tpu_torch.ingest.chunks import (
    ArrayChunks,
    IterChunks,
    NpyShards,
    NpzShards,
    shard_for_process,
)
from mpitree_tpu_torch.ingest.sketch import FeatureSketch, SketchSet
from mpitree_tpu_torch.ingest.stream import (
    IngestResult,
    StreamedDataset,
    ingest_dataset,
    sketch_dataset,
)

__all__ = [
    "ArrayChunks",
    "FeatureSketch",
    "IngestResult",
    "IterChunks",
    "NpyShards",
    "NpzShards",
    "SketchSet",
    "StreamedDataset",
    "ingest_dataset",
    "shard_for_process",
    "sketch_dataset",
]
