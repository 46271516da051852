"""The reference's dense half of each model family, one module a value of a
configuration's ``interaction`` (``manifest.Manifest.dense``).  Plain
PyTorch: nothing of the program."""
