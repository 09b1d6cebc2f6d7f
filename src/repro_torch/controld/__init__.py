"""Control-plane policies (the controld session service is not ported yet)."""
