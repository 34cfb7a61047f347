"""Sharding of the stream/frame batch axes over a list of devices."""

from .mesh import (CodecMesh, make_codec_mesh, shard_frames,
                   sharded_encode_step, sharded_roundtrip_step)

__all__ = ["CodecMesh", "make_codec_mesh", "shard_frames",
           "sharded_encode_step", "sharded_roundtrip_step"]
