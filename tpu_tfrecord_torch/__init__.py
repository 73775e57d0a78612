"""PyTorch/CUDA port of tpu_tfrecord for one NVIDIA H100.

TFRecord shards are written and read by a pure-Python host layer (``io``,
``wire``, ``proto``, ``serde``, ``columnar``, ``infer``), densified on the
host (``device.ingest``), copied to the card and scored by the Criteo DLRM
(``models``), whose dot interaction is a hand-written CUDA kernel
(``csrc/interaction.cu``). The package imports torch and numpy, never jax
and nothing of ``tpu_tfrecord``. Entry points run on ``cuda`` unless the
caller passes another device.
"""
