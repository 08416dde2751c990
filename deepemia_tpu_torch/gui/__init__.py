"""The web control panel (``server``)."""
