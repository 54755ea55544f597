"""One driver a kind of traffic mix, found by the mix's "driver" key."""
