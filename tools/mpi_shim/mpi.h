/* Single-rank MPI shim — just enough of the MPI-3 surface to compile and run
 * the reference HySortK binary (/root/reference) as a golden test oracle on a
 * machine with no MPI installation. Communicator size is always 1, so every
 * collective degenerates to a memcpy or a no-op.
 *
 * This is test tooling for the hysortk_tpu project; it is NOT a general MPI.
 */
#ifndef HYSORTK_MPI_SHIM_H_
#define HYSORTK_MPI_SHIM_H_

#include <stddef.h>
#include <stdio.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Datatype handles encode the element size in bytes. */
typedef int MPI_Datatype;
#define MPI_BYTE               ((MPI_Datatype)1)
#define MPI_CHAR               ((MPI_Datatype)1)
#define MPI_INT                ((MPI_Datatype)4)
#define MPI_DOUBLE             ((MPI_Datatype)8)
#define MPI_UNSIGNED_LONG      ((MPI_Datatype)8)
#define MPI_UNSIGNED_LONG_LONG ((MPI_Datatype)8)

typedef int MPI_Comm;
#define MPI_COMM_WORLD ((MPI_Comm)0)

typedef int MPI_Op;
#define MPI_MAX ((MPI_Op)1)
#define MPI_SUM ((MPI_Op)2)

typedef int MPI_Request;
typedef struct { int MPI_SOURCE, MPI_TAG, MPI_ERROR; } MPI_Status;
#define MPI_STATUS_IGNORE ((MPI_Status *)0)
#define MPI_STATUSES_IGNORE ((MPI_Status *)0)

typedef int MPI_Info;
#define MPI_INFO_NULL ((MPI_Info)0)

typedef long long MPI_Offset;
typedef FILE *MPI_File;
#define MPI_MODE_RDONLY 2
#define MPI_FILE_READ_AT_ALL 0

#define MPI_IN_PLACE ((void *)(-1))
#define MPI_SUCCESS 0

int MPI_Init(int *argc, char ***argv);
int MPI_Finalize(void);
int MPI_Abort(MPI_Comm comm, int errorcode);
int MPI_Comm_rank(MPI_Comm comm, int *rank);
int MPI_Comm_size(MPI_Comm comm, int *size);
double MPI_Wtime(void);
int MPI_Barrier(MPI_Comm comm);

int MPI_Bcast(void *buffer, int count, MPI_Datatype dt, int root, MPI_Comm c);
int MPI_Reduce(const void *sendbuf, void *recvbuf, int count, MPI_Datatype dt,
               MPI_Op op, int root, MPI_Comm c);
int MPI_Allreduce(const void *sendbuf, void *recvbuf, int count,
                  MPI_Datatype dt, MPI_Op op, MPI_Comm c);
int MPI_Exscan(const void *sendbuf, void *recvbuf, int count, MPI_Datatype dt,
               MPI_Op op, MPI_Comm c);
int MPI_Scatterv(const void *sendbuf, const int *sendcounts, const int *displs,
                 MPI_Datatype sendtype, void *recvbuf, int recvcount,
                 MPI_Datatype recvtype, int root, MPI_Comm c);
int MPI_Gather(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
               void *recvbuf, int recvcount, MPI_Datatype recvtype, int root,
               MPI_Comm c);
int MPI_Gatherv(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                void *recvbuf, const int *recvcounts, const int *displs,
                MPI_Datatype recvtype, int root, MPI_Comm c);
int MPI_Alltoallv(const void *sendbuf, const int *sendcounts,
                  const int *sdispls, MPI_Datatype sendtype, void *recvbuf,
                  const int *recvcounts, const int *rdispls,
                  MPI_Datatype recvtype, MPI_Comm c);
int MPI_Ialltoall(const void *sendbuf, int sendcount, MPI_Datatype sendtype,
                  void *recvbuf, int recvcount, MPI_Datatype recvtype,
                  MPI_Comm c, MPI_Request *request);
int MPI_Wait(MPI_Request *request, MPI_Status *status);

int MPI_Type_contiguous(int count, MPI_Datatype oldtype, MPI_Datatype *newtype);
int MPI_Type_commit(MPI_Datatype *dt);
int MPI_Type_free(MPI_Datatype *dt);

int MPI_File_open(MPI_Comm c, const char *filename, int amode, MPI_Info info,
                  MPI_File *fh);
int MPI_File_close(MPI_File *fh);
int MPI_File_get_size(MPI_File fh, MPI_Offset *size);
int MPI_File_read_at_all(MPI_File fh, MPI_Offset offset, void *buf, int count,
                         MPI_Datatype dt, MPI_Status *status);

#ifdef __cplusplus
}
#endif

#endif /* HYSORTK_MPI_SHIM_H_ */
