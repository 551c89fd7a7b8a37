"""MD loop of the port: integrator, thermostat, replica-batch simulation."""
