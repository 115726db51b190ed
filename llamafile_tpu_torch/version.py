"""Version string (reference: llamafile/version.h:6-11); the port's own copy
of llamafile_tpu/version.py."""
VERSION = (0, 1, 0)
VERSION_STRING = ".".join(map(str, VERSION))
