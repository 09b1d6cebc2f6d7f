"""Test-support utilities shipped with the package (fault injection, the
property-testing front end)."""
