"""Environment smoke check (equivalent of ref: test_env.py).

Prints versions of the numerics stack and the visible accelerator topology.
Run: ``python3 -m opticalflow_ri.utils.envcheck``
"""

from __future__ import annotations


def report() -> dict:
    info = {}
    import numpy

    info["numpy"] = numpy.__version__
    import scipy

    info["scipy"] = scipy.__version__
    try:
        import PIL

        info["pillow"] = PIL.__version__
    except ImportError:  # optional: only the PIL image-IO fallback needs it
        info["pillow"] = None
    import jax

    info["jax"] = jax.__version__
    try:
        devices = jax.devices()
        info["backend"] = jax.default_backend()
        info["devices"] = [str(d) for d in devices]
        info["device_count"] = len(devices)
    except Exception as e:  # tolerate missing accelerator, like the reference
        info["backend_error"] = repr(e)
    try:
        import matplotlib

        info["matplotlib"] = matplotlib.__version__
    except Exception:
        info["matplotlib"] = None
    return info


def main():
    for key, val in report().items():
        print(f"{key}: {val}")


if __name__ == "__main__":
    main()
