"""``compat.EstimHelpers.*``: the reference helpers' module paths on the
port (the reference's ``EstimHelpers/__init__.py`` carries only a version
string)."""

__version__ = "0.1.0"
