"""One module per traffic driver, named by a mix's ``"driver"`` key."""
