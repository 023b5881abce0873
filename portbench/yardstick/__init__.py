"""What the benchmark measures against: the card's peaks, the work a
lane-building kernel's launch needs, and the reading of a device trace."""
