"""ctypes bindings for the native C++ FFmpeg decoder (native/video_decoder.cpp).

Importing this module raises if the shared library is absent — build it with
``make -C native`` (it links the system libav*). ``VideoReader.from_path``
falls back to the OpenCV reader automatically when unavailable.
"""

import ctypes
import logging
import os
from typing import Optional, Sequence, Union

import numpy as np

from fitclip_tpu.data.video_reader import (VideoReader, _nearest_indices,
                                           scaled_size)

LOGGER = logging.getLogger(__name__)

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "libfitclip_decoder.so")


def _load_library() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        # ImportError so that `pytest.importorskip` and `try: import` gates
        # treat a missing/unbuildable .so as "module unavailable" rather
        # than an error (`make -C native` builds it).
        raise ImportError(f"native decoder library unavailable: {e}") from e
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_open_scaled.restype = ctypes.c_void_p
    lib.vd_open_scaled.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vd_open_threaded.restype = ctypes.c_void_p
    lib.vd_open_threaded.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.vd_num_frames.restype = ctypes.c_int
    lib.vd_num_frames.argtypes = [ctypes.c_void_p]
    lib.vd_avg_fps.restype = ctypes.c_double
    lib.vd_avg_fps.argtypes = [ctypes.c_void_p]
    lib.vd_frame_size.restype = None
    lib.vd_frame_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.vd_timestamps.restype = None
    lib.vd_timestamps.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.vd_keyframes.restype = None
    lib.vd_keyframes.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint8)]
    lib.vd_get_frames.restype = ctypes.c_int
    lib.vd_get_frames.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                  ctypes.c_int]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [ctypes.c_void_p]
    return lib


_LIB = _load_library()

_FALLBACK_SHAPE = (256, 256, 3)


class NativeVideoReader(VideoReader):
    """Indexed reads through the C++ decoder; decord-compatible error
    tolerance (zeros instead of raising) and timestamp-based seeks."""

    def __init__(self, path, resize_hw=None,
                 short_side: Optional[int] = None,
                 decode_threads: int = 1) -> None:
        super().__init__(path)
        self.resize_hw = resize_hw  # optional (h, w) swscale-while-decoding
        self.short_side = short_side  # aspect-preserving downscale-at-decode
        # short_side also engages lowres (DCT-domain) decoding for codecs
        # that support it — see native/video_decoder.cpp vd_open_scaled.
        # decode_threads > 1 decodes the sampled keyframes of intra-only
        # streams in parallel codec frame threads (a latency lever for
        # multi-core hosts; 1 = decord-parity default).
        self._handle = _LIB.vd_open_threaded(str(path).encode(),
                                             int(short_side or 0),
                                             int(decode_threads))
        if not self._handle:
            LOGGER.error("An error occurred when trying to load the video "
                         "with path %s.", self.path)
        self._timestamps = None

    def __call__(self, indices: Sequence[int]) -> np.ndarray:
        if self._handle:
            indices_arr = np.asarray(list(indices), dtype=np.int64)
            if self.resize_hw:
                height, width = self.resize_hw
            else:
                h = ctypes.c_int()
                w = ctypes.c_int()
                _LIB.vd_frame_size(self._handle, ctypes.byref(h), ctypes.byref(w))
                height, width = h.value, w.value
                # Engage decode-time scaling only when the source is >= 2x
                # the target short side: there the lowres DCT decode and/or
                # the much-smaller swscale output pay for themselves. Below
                # 2x, a 1:1 conversion + the transform's SIMD cv2 resize is
                # faster than a bicubic swscale.
                if self.short_side and min(height, width) >= 2 * self.short_side:
                    height, width = scaled_size(height, width, self.short_side)
            out = np.empty((len(indices_arr), height, width, 3), dtype=np.uint8)
            code = _LIB.vd_get_frames(
                self._handle,
                indices_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(indices_arr),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                height, width)
            if code == 0:
                return out
            LOGGER.error("An error occurred when trying to read the video with "
                         "path %s and indices %s.", self.path, list(indices))
        return np.zeros((len(list(indices)), *_FALLBACK_SHAPE), dtype=np.uint8)

    @property
    def ok(self) -> bool:
        return bool(self._handle)

    def __len__(self) -> int:
        return _LIB.vd_num_frames(self._handle) if self._handle else 1

    def keyframe_flags(self) -> np.ndarray:
        """Per-frame 0/1 keyframe flags (the GOP structure); ones when the
        file failed to open (matching the zero-fill tolerance posture)."""
        n = len(self)
        if not self._handle:
            return np.ones((n,), np.uint8)
        out = np.empty((n,), np.uint8)
        _LIB.vd_keyframes(self._handle,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out

    def time_to_indices(self, time: Union[float, Sequence[float]]) -> np.ndarray:
        if not self._handle:
            return np.zeros_like(np.asarray(time), dtype=int)
        if self._timestamps is None:
            n = len(self)
            self._timestamps = np.empty(n, dtype=np.float64)
            _LIB.vd_timestamps(
                self._handle,
                self._timestamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return _nearest_indices(self._timestamps, time)

    def get_avg_fps(self) -> float:
        return _LIB.vd_avg_fps(self._handle) if self._handle else 1.0

    def __del__(self):
        if getattr(self, "_handle", None):
            _LIB.vd_close(self._handle)
            self._handle = None
