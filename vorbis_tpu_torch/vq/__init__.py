"""Offline VQ/Huffman codebook training toolchain (reference: vq/ —
vqgen.c, latticebuild.c, latticetune.c, huffbuild.c, distribution.c).

The reference trains books with scalar LBG loops over dump files
emitted by TRAIN_RES/TRAIN_FLOOR1 builds of the encoder.  Here the
training-vector collection is an opt-in hook on the Encoder
(collect_training), and the LBG/assignment steps are batched matmul
distance computations.

Counterpart of vorbis_tpu/vq: `lbg_train`'s step runs on a torch device
(vqgen.py); huffbuild.py, latticebuild.py and training.py are
line-aligned copies of their sources (numpy).
"""

from .huffbuild import huffbuild, occupancy_from_entries
from .latticebuild import latticebuild, latticetune
from .vqgen import lbg_train

__all__ = ["lbg_train", "huffbuild", "occupancy_from_entries",
           "latticebuild", "latticetune"]
