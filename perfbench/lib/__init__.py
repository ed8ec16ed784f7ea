"""The benchmark's yardstick: seeded inputs, traffic, trace reading,
peaks and costs, the comparison."""
