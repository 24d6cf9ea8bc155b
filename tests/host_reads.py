"""The dispatch mode the round-program tests run a round's body under:
:class:`NoHostReads` refuses every op that reads a device value on the
host (``aten::_local_scalar_dense``, ``is_nonzero``, ``nonzero``) and every
copy of a tensor to another device, so a body that passes under it has no
host sync to break a CUDA graph's capture on the card. Imported by
``tests/test_torch_run_rounds.py``, ``tests/test_torch_mesh_rounds.py`` and
``tests/test_torch_round_program.py``."""
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the ops that read a device value on the host
HOST_READS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero")


class NoHostReads(TorchDispatchMode):
    """Refuses every op that reads a tensor's value on the host, and every
    copy of a tensor to another device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if name in HOST_READS:
            raise AssertionError(f"host read in the round body: {name}")
        if name == "aten._to_copy" and "device" in kwargs:
            src = args[0].device
            if torch.device(kwargs["device"]) != src:
                raise AssertionError(f"copy from {src} to "
                                     f"{kwargs['device']} in the round body")
        if name == "aten.copy_" and args[0].device != args[1].device:
            raise AssertionError(f"copy from {args[1].device} to "
                                 f"{args[0].device} in the round body")
        return func(*args, **kwargs)

