"""Part of jpegtpu_torch; see the package docstring."""
