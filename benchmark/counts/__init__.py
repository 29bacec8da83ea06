"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of the work each cell does, counted from its shapes."""
