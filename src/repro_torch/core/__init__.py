"""Neuron core of the port: mechanisms, Hines solve, cell model, BDF,
event queues and the execution models.  float64 throughout, as the JAX
package's ``repro.core`` runs with x64 enabled."""
