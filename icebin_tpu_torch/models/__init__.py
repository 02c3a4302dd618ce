"""Ice-sheet model of the port."""
