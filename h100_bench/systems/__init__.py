"""The system under test for each model family, one module a value of a
configuration's ``interaction`` (``manifest.Manifest.system``): the only
modules of the benchmark that import the program."""
