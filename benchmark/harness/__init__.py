"""The benchmark's harness: the manifest and the files it names, the
inputs and weights from the seed, the window, the profiled stretch and
its readers, and the comparison with the plain reference.  The program
under test (``scale_imagenet_tpu_torch``) is imported inside the
functions that drive it (``cell``, ``faults``), never at import."""
