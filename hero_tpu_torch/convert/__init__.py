"""Parameter bridges into the port's layout."""
