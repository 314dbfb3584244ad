"""Several devices and several processes.

The counterpart of ``segmentation3d_tpu/parallel/``. At inference time
:mod:`.devices` builds the list of devices one process drives
(``make_mesh``'s counterpart) and the copies and stream ordering that stand
in for the mesh's ``ppermute`` and ``psum``. For training, one process per
device: :mod:`.train_mesh` lays the ranks out as JAX's ``(data, spatial)``
mesh and :mod:`.collectives` holds the all-reduces autograd differentiates.
:mod:`.distributed` joins the processes' group: gloo for inference's
host-side coordination, the backend rule's for training.
"""
from segmentation3d_tpu_torch.parallel.devices import distinct, shard_devices  # noqa: F401
