"""The benchmark's yardstick: peaks, FLOP and byte counts, traffic, seeded
weights and the reduction of a profile to device times."""
