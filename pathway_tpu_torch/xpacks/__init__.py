"""Extension packs of the port."""
