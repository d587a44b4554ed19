"""glusterfs_tpu_torch: the disperse data path of glusterfs_tpu on
PyTorch, with its GF(256) erasure-coding kernels written by hand in CUDA
for an NVIDIA Hopper card.

It mirrors the module layout of the JAX package (``glusterfs_tpu``) and
shares its on-disk brick format, so either package mounts bricks the
other wrote.  It imports nothing of that package.  The codec runs on
the card unless the caller asks for the CPU
(``cpu-extensions torch`` on a volume, ``Codec(..., backend="torch",
device="cpu")`` directly).
"""

__version__ = "0.1.0"

# Management op-version of the JAX package this port tracks (peers
# advertise it at probe time; see glusterfs_tpu.__init__ for the history).
OP_VERSION = 19
