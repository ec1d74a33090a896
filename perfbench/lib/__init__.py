"""The harness: inputs, weights, comparison, costs, trace reduction."""
