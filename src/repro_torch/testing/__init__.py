"""Test-support utilities shipped with the package (fault injection)."""
