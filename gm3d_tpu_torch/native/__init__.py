"""Native (C++) host components: the threaded cloud loader (``loader.cpp``)."""

from gm3d_tpu_torch.native.native_loader import (
    NativeCloudLoader,
    NativeLabelledCloudLoader,
    build_library,
    load_library,
)

__all__ = ["NativeCloudLoader", "NativeLabelledCloudLoader", "build_library", "load_library"]
