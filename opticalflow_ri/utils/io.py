"""Image loading and PIV-tool-compatible flow persistence.

``save_flow`` writes the exact MATLAB schema the reference's harness emits
(ref: examples/PyHSchunck_Fs3_4.py:35-51, benchmark_of_methods.py:33-54):
velocities{u, v, iaWidth, iaHeight, margins} + parameters{overlapFactor,
imageHeight, imageWidth}, so downstream PIV tooling keeps working unchanged.
"""

from __future__ import annotations

import numpy as np


def load_image(path) -> np.ndarray:
    """Load a grayscale image (TIFF etc.) as float32, like the reference's
    ``skimage.io.imread(...).astype(np.float32)``.

    Uncompressed grayscale TIFFs decode through the native C++ runtime
    (utils/native) when available; anything else falls back to PIL with
    identical pixel values."""
    if str(path).lower().endswith((".tif", ".tiff")):
        from opticalflow_ri.utils import native

        arr = native.tiff_read(str(path)) if native.available() else None
        if arr is not None:
            return arr
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float32)


def load_image_batch(paths) -> np.ndarray:
    """Threaded batch decode of equally-sized frames into one (N, H, W)
    float32 array (native C++ fast path, PIL fallback)."""
    from opticalflow_ri.utils import native

    if native.available():
        arr = native.tiff_read_batch([str(p) for p in paths])
        if arr is not None:
            return arr
    return np.stack([load_image(p) for p in paths])


def save_flow(U, V, filename) -> None:
    import scipy.io

    U = np.asarray(U)
    V = np.asarray(V)
    margins = {"top": 0, "left": 0, "bottom": 0, "right": 0}
    results = {"u": U, "v": V, "iaWidth": 1, "iaHeight": 1, "margins": margins}
    parameters = {
        "overlapFactor": 1.0,
        "imageHeight": U.shape[0],
        "imageWidth": U.shape[1],
    }
    scipy.io.savemat(
        filename, mdict={"velocities": results, "parameters": parameters}
    )


def normalize_16bit_to_8bit(img: np.ndarray) -> np.ndarray:
    """16-bit to 8-bit range normalisation used by the benchmark harness
    (ref: benchmark_of_methods.py:134-137)."""
    if img.max() > 255:
        return (img / 65535.0 * 255.0).astype(np.float32)
    return img.astype(np.float32)
