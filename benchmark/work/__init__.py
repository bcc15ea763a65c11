"""The operations and bytes each hand-written kernel's function needs at
a call's shapes, and the card's peaks: the yardstick of the roofline
shares. Each input byte is counted once and each output byte once."""
