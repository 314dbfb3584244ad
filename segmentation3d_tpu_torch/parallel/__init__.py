"""Several devices and several processes at inference time.

The counterpart of ``segmentation3d_tpu/parallel/``: :mod:`.devices` builds
the list of devices one process drives (``make_mesh``'s counterpart) and the
copies and stream ordering that stand in for the mesh's ``ppermute`` and
``psum``; :mod:`.distributed` coordinates several processes over a gloo
group (host-side only: no device collective).
"""
from segmentation3d_tpu_torch.parallel.devices import distinct, shard_devices  # noqa: F401
