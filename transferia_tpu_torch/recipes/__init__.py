"""In-process wire fakes of the brokers and databases the port's
providers speak to: a Kafka broker, a Confluent schema registry,
Postgres, MySQL and a ClickHouse HTTP endpoint.  They run the real
clients against real localhost sockets; only the server side is fake."""
